"""The benchmark of the PyTorch/CUDA port (`legged_mpc_control_tpu_torch`).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell once on the card it starts on and prints, as the last line of
its standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics`, `device` (and `breakdown` with `--trace 1`), then the numbers the
correctness check compared, under `checks`.

Everything is found by name from `BENCHMARK.json`: the cell names a
configuration (its `file`, which names the driver `benchmark/drivers/
<driver>.py`) and a traffic mix (`benchmark/traffic/<traffic>.json`); each
per-layer metric is read by `benchmark/metrics/<name>.py`. A cell, a
configuration, a mix or a per-layer metric is added by adding files and
entries.

A run: set-up (imports, the kernels' libraries, the batch made on the
device from `--seed`, the warm-up ticks), then a window of `--seconds` in
which the cell's tick is called back to back with no host sync, a CUDA
event recorded at each tick's end; then the correctness check against the
plain reference under `benchmark/reference/`. With `--trace 1` the window
runs under torch.profiler and the per-layer metrics are read from its
device trace.
"""

import argparse
import contextlib
import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# build and kernel caches the run could write, at fixed paths inside the
# checkout (the port's own nvcc builds go to its fixed `_build/`)
CACHE = BENCH / "_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "legged_mpc_control_tpu")
GIB = float(2 ** 30)


class BenchError(RuntimeError):
    """A run that cannot produce a result: no card, a malformed cell, the
    JAX package loaded."""


def forbidden_loaded(names=None):
    """Top-level names of `names` (default: `sys.modules`) that are JAX or
    the JAX package, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def _check_imports(when):
    found = forbidden_loaded()
    if found:
        raise BenchError(f"{when}: forbidden modules loaded: "
                         f"{', '.join(found)}")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def applies(metric, cell):
    """Whether an end-to-end metric applies to `cell`."""
    return "workloads" not in metric or cell["name"] in metric["workloads"]


def cell_spec(workload, root=ROOT):
    """The cell named `workload` with everything it needs, found by name:
    {cell, config, traffic, end_to_end, per_layer}."""
    spec = load_json(Path(root) / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json; "
                         f"there are {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(Path(root) / configs[cell["config"]]["file"])
    traffic = load_json(Path(root) / "benchmark" / "traffic"
                        / f"{cell['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if applies(m, cell)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (cell["name"] in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return dict(cell=cell, config=config, traffic=traffic, end_to_end=e2e,
                per_layer=per_layer, root=Path(root))


def _load(root, kind, name):
    """The module `benchmark/<kind>/<name>.py` of the checkout at `root`."""
    path = Path(root) / "benchmark" / kind / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no {kind[:-1]} {name!r}: {path} is missing")
    modname = f"benchmark.{kind}.{name}"
    if modname in sys.modules and Path(
            sys.modules[modname].__file__).resolve() == path.resolve():
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[modname] = module
    spec.loader.exec_module(module)
    return module


def load_driver(root, name):
    return _load(root, "drivers", name)


def load_metric(root, name):
    return _load(root, "metrics", name)


def quantile(values, q):
    """The q-quantile (0 < q < 1) of `values`, linearly interpolated
    between order statistics (`statistics.quantiles`, inclusive)."""
    vals = sorted(values)
    if len(vals) == 1:
        return vals[0]
    pos = q * (len(vals) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


class CudaClock:
    """The card's side of a window: synchronize, and events recorded on the
    current stream whose pairwise elapsed times are read after the
    window."""

    def __init__(self, torch):
        self.torch = torch

    def sync(self):
        self.torch.cuda.synchronize()

    def mark(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @staticmethod
    def elapsed_ms(a, b):
        return a.elapsed_time(b)


def run_window(cell, seconds, clock, trace=None):
    """Call `cell.tick()` back to back until `seconds` have passed on the
    host clock, an event marked after each tick; the window opens and
    closes on `clock.sync()`. `trace`: a context manager entered around
    the window (the profiler). Returns {ticks, wall_s, tick_ms (every
    tick's interval between consecutive tick-end events), host_s (host
    time inside the tick calls), t_open (host clock at the first tick)}."""
    clock.sync()
    marks = []
    host_s = 0.0
    with trace if trace is not None else contextlib.nullcontext():
        clock.sync()
        opened = clock.mark()
        t_open = time.perf_counter()
        deadline = t_open + seconds
        while True:
            h0 = time.perf_counter()
            cell.tick()
            h1 = time.perf_counter()
            host_s += h1 - h0
            marks.append(clock.mark())
            if h1 >= deadline:
                break
        clock.sync()
        wall_s = time.perf_counter() - t_open
    ends = [opened] + marks
    tick_ms = [clock.elapsed_ms(a, b) for a, b in zip(ends, ends[1:])]
    return dict(ticks=len(marks), wall_s=wall_s, tick_ms=tick_ms,
                host_s=host_s, t_open=t_open)


def end_to_end(window, batch, setup_s, peak_bytes):
    """The end-to-end metrics of a window, by name."""
    return {
        "scenario_ticks_per_s": batch * window["ticks"] / window["wall_s"],
        "tick_ms_p95": quantile(window["tick_ms"], 0.95),
        "peak_mem_gib": peak_bytes / GIB,
        "setup_s": setup_s,
    }


def power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"nvidia-smi gave nothing (rc {out.returncode})")


def judge(checks):
    """correct: every compared number finite and within its limit."""
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def check_lines(checks):
    return [f"check {name} = {value!r} (limit {limit!r}): "
            f"{'ok' if math.isfinite(value) and value <= limit else 'FAIL'}"
            for name, value, limit in checks]


def measure(spec, seed, seconds, trace, device, clock, t_start,
            control=False):
    """One run of a cell on `device`: set-up, window, quality, trace
    reading and correctness check. Returns (result dict, info lines, the
    numbers compared, the driver's cell)."""
    import torch

    from benchmark import tracing

    t_cell = time.perf_counter()
    driver = load_driver(spec["root"], spec["config"]["driver"])
    cell = driver.Cell(spec["config"], spec["traffic"], seed, device,
                       control=control)
    cell.setup()
    t_ready = time.perf_counter()
    prof = tracing.Profile(cell.layers()) if trace else None
    window = run_window(cell, seconds, clock, prof)
    setup_s = window["t_open"] - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    quality = cell.quality()
    _check_imports("after the window")

    info = [f"window: {window['ticks']} ticks of B={cell.batch} in "
            f"{window['wall_s']!r} s; tick median "
            f"{statistics.median(window['tick_ms'])!r} ms, p95 "
            f"{quantile(window['tick_ms'], 0.95)!r} ms (CUDA events); "
            f"host time in the tick calls {window['host_s']!r} s"
            + ("; under torch.profiler" if trace else "")]
    info.append(f"set-up {setup_s!r} s: {t_cell - t_start!r} s to import "
                "and reach the card, "
                f"{t_ready - t_cell!r} s the cell's (the batch, the kernels' "
                "libraries, the warm-up ticks)")
    info.append("quality at the window's end: " + ", ".join(
        f"{k} {v!r}" for k, v in quality.items()))
    result = dict(attempted=cell.batch * window["ticks"],
                  failed=quality["nonfinite"] * window["ticks"])
    device_info = dict(
        platform="gpu" if device.type == "cuda" else device.type,
        kind=(torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu"),
        count=1, memory_peak_bytes=int(peak))
    if trace:
        tr = prof.trace(window, cell)
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        metrics = {}
        for m in spec["per_layer"]:
            value = load_metric(spec["root"], m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = tracing.breakdown(tr)
        info.append(f"trace: {len(tr.ops)} device operations, busy "
                    f"{tr.busy_s!r} of {tr.window_s!r} s; read in "
                    f"{tr.read_s!r} s; " + tracing.launch_summary(tr)
                    + "; host_ms_per_tick is measured under the profiler "
                    "and counts the host's waits for a free slot in the "
                    "launch queue")
    else:
        e2e = end_to_end(window, cell.batch, setup_s, peak)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    info.append(f"card: {power_limit() if device.type == 'cuda' else 'cpu'}"
                "; rooflines against the H100 SXM data sheet (3.35 TB/s, "
                "67 / 34 TFLOP/s float32 / float64)")
    checks = cell.check()
    result.update(correct=judge(checks), metrics=metrics, device=device_info,
                  checks={name: {"value": v, "limit": lim}
                          for name, v, lim in checks})
    info.append("reference: " + cell.check_note)
    return result, info, checks, cell


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start):
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    try:
        _check_imports("at start")
        spec = cell_spec(args.workload)
        import torch

        if not torch.cuda.is_available():
            raise BenchError("no CUDA device: torch.cuda.is_available() is "
                             "false; the benchmark runs on the card only")
        chips = spec["cell"]["chips"]
        if torch.cuda.device_count() < chips:
            raise BenchError(f"the cell asks for {chips} cards, "
                             f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
        result, info, checks, _ = measure(
            spec, args.seed, args.seconds, bool(args.trace), device,
            CudaClock(torch), t_start)
        _check_imports("at the end")
    except (BenchError, ImportError) as e:
        print(f"benchmark: {e}", file=sys.stderr, flush=True)
        return 2
    # the line before the last: the window, the quality statistics, the card
    print(" | ".join(info), flush=True)
    for line in check_lines(checks):
        print(line, file=sys.stderr, flush=True)
    keys = ("correct", "attempted", "failed", "metrics", "device",
            "breakdown", "checks")
    print(json.dumps({k: result[k] for k in keys if k in result}),
          flush=True)
    return 0
