"""Where the host's time a tick goes, by the port's own layer spans, in a
benchmark cell's traced window on the card.

    python3 tools/lmpc_spans.py --workload <cell> --seed <n> --seconds <s> \
        [--windows on,sync,off,...] [--span-cost]

Sets the cell up as `benchmark/run.py` does and runs one window after
another in the one process, each under the benchmark's profile
(`benchmark/tracing.Profile`), and prints one JSON line a window: its
kind and ticks; `host_ms_per_tick` (the harness's host clock in the tick
calls); `host_enqueue_ms_per_tick` and `host_syncs_per_tick` as the
benchmark reads them (`benchmark/program_spans.py`), and the same enqueue
arithmetic over the "tick" span the benchmark patches around the cell's
tick (which a program without spans has too); each "lmpc." span's host
self time and calls a tick; each wait (a synchronizing call, a launch
queued behind a full queue) by its innermost span; the API calls inside
the kernel spans a tick (a hand-written kernel's launch shows as a runtime
call there); the device's idle share and the breakdown's longest gaps.

A window is "on" (ticks back to back, as the benchmark's), "sync" (the
card waited for before every tick, outside the tick's spans, so no launch
queues behind a full queue: the host's time in the tick spans less their
synchronizing calls is then the enqueue cost that an "on" window's
`host_enqueue_ms_per_tick` estimates) or "off" (back to back with the
port's span helper forced off, the spans' cost when the profiler
records). Alternating the kinds in one process keeps the host's speed,
which moves between processes, out of the comparison. --span-cost first
prints the helper's cost a span with no profiler and under one.
Needs a CUDA device.
"""

import argparse
import collections
import json
import sys
import time
import timeit
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import harness, program_spans, tracing  # noqa: E402
from legged_mpc_control_tpu_torch.utils import trace  # noqa: E402

KERNEL_SPANS = ("lmpc.k1", "lmpc.k2", "lmpc.k7")


def span_cost_us(n=200_000):
    """The span helper's cost a span (enter and exit) in us: with no
    profiler, and while a CPU profile records."""
    def one():
        with trace.span(trace.TICK):
            pass
    off = min(timeit.repeat(one, number=n, repeat=3)) / n * 1e6
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = min(timeit.repeat(one, number=n // 10, repeat=3)) / (n // 10)
    return {"span_off_us": off, "span_on_us": on * 1e6}


class _SyncEachTick:
    def __init__(self, cell):
        self.cell = cell

    def tick(self):
        torch.cuda.synchronize()
        self.cell.tick()


def self_times(spans):
    """{name: total self time (us)}: each span's duration less its
    children's (the spans of one thread nest)."""
    out = collections.Counter()
    stack = []
    for name, s, e in sorted(spans, key=lambda sp: (sp[1], -sp[2])):
        while stack and stack[-1][2] <= s:
            stack.pop()
        if stack:
            out[stack[-1][0]] -= e - s
        out[name] += e - s
        stack.append((name, s, e))
    return out


def report(tr, side, window):
    ticks = tr.ticks
    per_tick = {}
    out = dict(ticks=ticks, host_ms_per_tick=window["host_s"] * 1e3 / ticks,
               device_idle_pct=100.0 * (1.0 - tr.busy_s / tr.window_s))
    patched = program_spans.HostSide(
        spans=[(program_spans.TICK, s, e) for n, s, e in tr.spans
               if n == "tick"], calls=side.calls)
    out["patched_tick_enqueue_ms_per_tick"] = (
        program_spans.enqueue_ms_per_tick(patched, ticks))
    out["patched_tick_syncs_per_tick"] = program_spans.syncs_per_tick(
        patched, ticks)
    if side.ticks():
        out["host_enqueue_ms_per_tick"] = program_spans.enqueue_ms_per_tick(
            side, ticks)
        out["host_syncs_per_tick"] = program_spans.syncs_per_tick(side,
                                                                  ticks)
        counts = collections.Counter(n for n, _, _ in side.spans)
        for name, us in sorted(self_times(side.spans).items()):
            per_tick[name] = {"self_ms": us * 1e-3 / ticks,
                              "calls": counts[name] / ticks}
        waited = collections.defaultdict(lambda: [0, 0.0])
        for name, s, _, w in program_spans.waits(side):
            key = f"{name} in {program_spans.innermost(side, s)}"
            waited[key][0] += 1
            waited[key][1] += w
        out["waits_per_tick"] = {k: {"n": n / ticks, "ms": w * 1e-3 / ticks}
                                 for k, (n, w) in sorted(waited.items())}
        inside = collections.Counter()
        for name, s, e in side.spans:
            if name in KERNEL_SPANS:
                for c in side.calls_in(s, e):
                    inside[f"{c[0]} in {name}"] += 1
        out["calls_in_kernel_spans_per_tick"] = {
            k: v / ticks for k, v in sorted(inside.items())}
    out["spans_per_tick"] = per_tick
    calls = collections.defaultdict(list)
    for name, s, e in side.calls:
        calls[name].append(e - s)
    out["api_calls_per_tick"] = {
        k: {"n": len(v) / ticks, "median_us": sorted(v)[len(v) // 2]}
        for k, v in sorted(calls.items())}
    program_spans.attach(tr, side)
    out["idle_gaps"] = tracing.breakdown(tr, n=6)["idle_gaps"]
    return out


def run(cell, kind, seconds):
    """One traced window of `kind` ("on", "sync", "off"): its report."""
    span = trace.span
    if kind == "off":
        trace.span = lambda name: trace._OFF
    try:
        prof = tracing.Profile(cell.layers())
        runner = _SyncEachTick(cell) if kind == "sync" else cell
        window = harness.run_window(runner, seconds,
                                    harness.CudaClock(torch), prof)
    finally:
        trace.span = span
    tr = prof.trace(window, cell)
    t0 = time.perf_counter()
    results = prof.prof.profiler.kineto_results
    side = program_spans.read_events(
        results.events(), results.trace_start_ns(), tr.window,
        torch.autograd.DeviceType.CUDA)
    out = dict(window=kind, trace_read_s=tr.read_s,
               spans_read_s=time.perf_counter() - t0)
    out.update(report(tr, side, window))
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--windows", default="on")
    ap.add_argument("--span-cost", action="store_true")
    args = ap.parse_args(argv)
    kinds = args.windows.split(",")
    if not set(kinds) <= {"on", "sync", "off"}:
        sys.exit(f"--windows: on, sync or off, not {args.windows}")
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    head = dict(workload=args.workload, seed=args.seed,
                card=harness.power_limit())
    if args.span_cost:
        print(json.dumps(dict(head, **span_cost_us())), flush=True)
    device = torch.device("cuda", 0)
    spec = harness.cell_spec(args.workload)
    driver = harness.load_driver(spec["root"], spec["config"]["driver"])
    cell = driver.Cell(spec["config"], spec["traffic"], args.seed, device)
    cell.setup()
    for kind in kinds:
        print(json.dumps(dict(head, **run(cell, kind, args.seconds))),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
