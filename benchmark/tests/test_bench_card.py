"""On the card: each cell runs end to end through `benchmark/run.py` with a
short window and prints a well-formed result line that reads correct.

    python3 -m pytest -o addopts="" benchmark/tests/test_bench_card.py -q"""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_a_cell_runs_on_the_card(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs on the card only")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 101), "--seconds", "2", "--trace",
         str(trace)], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
    spec = harness.cell_spec(workload)
    want = spec["per_layer"] if trace else spec["end_to_end"]
    assert set(result["metrics"]) <= {m["name"] for m in want}
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert len(result["breakdown"]["device_ops"]) <= 10
    else:
        assert set(result["metrics"]) == {m["name"] for m in want}
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
