"""BENCHMARK.json's cells, configurations, traffic mixes and metric
modules are all found by name; the file keeps to the benchmark's
contract; and a cell is added by adding files and entries only."""

import json
import re
import shutil

import pytest
import torch

from benchmark import harness
from benchmark.tests.hostclock import HostClock

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
LINE = re.compile(r"[^\t\n]{1,200}\Z")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_found_by_name(cell):
    spec = harness.cell_spec(cell["name"])
    assert spec["config"]["name"] == cell["config"]
    harness.load_driver(spec["root"], spec["config"]["driver"])
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(harness.load_metric(spec["root"], m["name"]).read)


def test_names_units_and_lines():
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in names
            names.add((group, entry["name"]))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("benchmark/")
        assert json.loads((harness.ROOT / c["file"]).read_text())[
            "name"] == c["name"]
        assert c["reduced"] == []
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        cells = {w["name"] for w in SPEC["workloads"]}
        assert set(m["workloads"]) <= cells


def test_a_cell_is_added_by_files_only(tmp_path):
    """On a copy: a new traffic mix and a new per-layer metric, each a file
    of its own, and entries in BENCHMARK.json; no existing file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    (root / "benchmark" / "traffic" / "tiny_b4.json").write_text(json.dumps(
        {"batch": 4, "velx": 0.15, "stand_ticks": 2, "walk_in_ticks": 1,
         "check_scenarios": 4}))
    (root / "benchmark" / "metrics" / "ticks_traced.py").write_text(
        "def read(tr):\n    return float(tr.ticks)\n")
    spec["workloads"].append({"name": "go1_convex.tiny_b4",
                              "config": "go1_convex", "traffic": "tiny_b4",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "ticks_traced", "unit": "ticks",
                              "better": "higher", "source": "host_clock",
                              "layer": "tick entry and host dispatch",
                              "moves": "scenario_ticks_per_s",
                              "workloads": ["go1_convex.tiny_b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert all(p.read_bytes() == b for p, b in before.items())

    cell = harness.cell_spec("go1_convex.tiny_b4", root=root)
    assert cell["traffic"]["batch"] == 4
    assert [m["name"] for m in cell["per_layer"]] == ["ticks_traced"]
    metric = harness.load_metric(cell["root"], "ticks_traced")
    assert metric.read(type("T", (), {"ticks": 3})()) == 3.0
    result, _, checks, _ = harness.measure(
        cell, seed=5, seconds=0.01, trace=False, device=torch.device("cpu"),
        clock=HostClock(), t_start=0.0)
    assert result["attempted"] > 0 and result["attempted"] % 4 == 0
    assert set(result["metrics"]) == {"scenario_ticks_per_s", "tick_ms_p95",
                                      "peak_mem_gib", "setup_s"}
    assert [name for name, _, _ in checks] == [
        "first.qp", "first.sim", "first.fbk", "last.qp", "last.sim",
        "last.fbk"]
