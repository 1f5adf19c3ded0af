"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole), the plain reference loads nothing of the port, and
`run.py` refuses to run without a card, with no fallback."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness

PY = sys.executable


def _modules_after(code):
    out = subprocess.run(
        [PY, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(harness.ROOT)))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_top_level_names_are_compared_whole():
    assert harness.forbidden_loaded(
        ["legged_mpc_control_tpu_torch", "legged_mpc_control_tpu_torch.ops",
         "opt_einsum.backends.jax", "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_loaded(
        ["jax.numpy", "jaxlib", "flax.linen",
         "legged_mpc_control_tpu.ops"]) == [
        "flax", "jax", "jaxlib", "legged_mpc_control_tpu"]


def test_the_benchmark_loads_no_jax():
    mods = _modules_after(
        "from benchmark import harness, tracing, tf32, compare, counts\n"
        "from benchmark.drivers import convex, ci\n"
        "import benchmark.control\n"
        "for w in ('go1_convex.sweep_b65536', 'a1_ci.b4096'):\n"
        "    s = harness.cell_spec(w)\n"
        "    for m in s['per_layer']:\n"
        "        harness.load_metric(s['root'], m['name'])\n"
        "    d = harness.load_driver(s['root'], s['config']['driver'])\n"
        "import torch\n"
        "cell = convex.Cell(harness.cell_spec("
        "'go1_convex.sweep_b65536')['config'], {'batch': 2, 'velx': 0.1, "
        "'stand_ticks': 1, 'walk_in_ticks': 0, 'check_scenarios': 2}, 1, "
        "torch.device('cpu'))\n"
        "cell.setup(); cell.tick(); cell.layers()\n"
        "c2 = ci.Cell(harness.cell_spec('a1_ci.b4096')['config'], "
        "{'batch': 1, 'velx': 0.1, 'tick_s': 0.01, 'walk_in_ticks': 1, "
        "'check_scenarios': 1}, 1, torch.device('cpu'))\n"
        "c2.layers()\n")
    assert "legged_mpc_control_tpu_torch" in {m.split(".")[0] for m in mods}
    assert harness.forbidden_loaded(mods) == []


def test_the_reference_loads_nothing_of_the_port():
    pkgs = sorted(p.relative_to(harness.ROOT).with_suffix("")
                  for p in (harness.BENCH / "reference").rglob("*.py"))
    names = [".".join(p.parts).removesuffix(".__init__") for p in pkgs]
    mods = _modules_after("\n".join(f"import {n}" for n in names))
    tops = {m.split(".")[0] for m in mods}
    assert "legged_mpc_control_tpu_torch" not in tops
    assert harness.forbidden_loaded(mods) == []
    for p in (harness.BENCH / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ImportFrom):
                assert node.level == 0 and node.module.split(".")[0] in (
                    "benchmark", "torch", "numpy", "dataclasses", "typing",
                    "functools", "math"), (p, node.module)
                if node.module.startswith("benchmark"):
                    assert node.module.startswith("benchmark.reference"), p
            elif isinstance(node, ast.Import):
                for a in node.names:
                    assert a.name.split(".")[0] in (
                        "torch", "numpy", "dataclasses", "math",
                        "functools"), (p, a.name)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    out = subprocess.run(
        [PY, "benchmark/run.py", "--workload", "go1_convex.sweep_b65536",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "{" not in out.stdout


def test_run_refuses_an_unknown_cell():
    out = subprocess.run(
        [PY, "benchmark/run.py", "--workload", "no_such.cell", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no workload" in out.stderr
    assert "{" not in out.stdout
