"""Device work and launches by the program span they were enqueued in, read
from the same profile as `benchmark/tracing.py` and `program_spans.py`.

The profiler gives each CUDA API call that enqueues work (a kernel launch,
a copy, a memset) a correlation id, and the device operation it enqueued
the same id. So the operations that a program span ("lmpc.<layer>",
`legged_mpc_control_tpu_torch/utils/trace.py`) launched are found wherever
they ran on the device's timeline, after the span has closed on the host.
`of(tr)` reads them once a Trace; None where the program has no spans (a
version older than them) or no profile is found, and then every metric
built on it reads None."""

import bisect
import re
from dataclasses import dataclass

from benchmark import program_spans

# the API calls that launch a kernel
LAUNCH = re.compile(r"cudaLaunch|cuLaunch")


@dataclass
class Launches:
    """The window's enqueuing API calls, each (name, start_us, end_us,
    correlation id), sorted by start; each id's device operations, (name,
    start_us, end_us) clipped to the window; the program's spans."""
    calls: list
    ops: dict
    spans: list


def read_events(events, t0_ns, window, device):
    """(calls, ops) of the window `(start_us, end_us)` from the profiler's
    raw events: the host's enqueuing API calls and the device's operations,
    each with its correlation id."""
    calls, ops = [], {}
    w0, w1 = window
    for ev in events:
        on_device = ev.device_type() == device
        name = ev.name()
        if not on_device and not (name[:1] == "c"
                                  and program_spans.QUEUE_CALL.match(name)):
            continue
        s = (ev.start_ns() - t0_ns) * 1e-3
        e = s + ev.duration_ns() * 1e-3
        if on_device:
            if e > w0 and s < w1:
                corr = ev.correlation_id() or ev.linked_correlation_id()
                ops.setdefault(corr, []).append((name, max(s, w0),
                                                 min(e, w1)))
        elif w0 <= s and e <= w1:
            calls.append((name, s, e, ev.correlation_id()))
    calls.sort(key=lambda c: c[1])
    return calls, ops


def of(tr):
    """The Launches of the traced window `tr`, read once; None where the
    program's spans are missing (`program_spans.of`)."""
    if not hasattr(tr, "launches"):
        side = program_spans.of(tr)
        prof = program_spans._open_profile() if side is not None else None
        if prof is None:
            tr.launches = None
        else:
            import torch

            results = prof.prof.profiler.kineto_results
            calls, ops = read_events(
                results.events(), results.trace_start_ns(), tr.window,
                torch.autograd.DeviceType.CUDA)
            tr.launches = Launches(calls=calls, ops=ops, spans=side.spans)
    return tr.launches


def _intervals(spans, name):
    """The outermost spans "lmpc.<name>", (starts, ends) sorted by start."""
    full, out = program_spans.PREFIX + name, []
    for n, s, e in sorted(spans, key=lambda sp: sp[1]):
        if n == full and not (out and e <= out[-1][1]):
            out.append((s, e))
    return [s for s, _ in out], [e for _, e in out]


def _inside(t0, t1, intervals):
    """Whether [t0, t1] lies inside one of `intervals` (`_intervals`)."""
    starts, ends = intervals
    i = bisect.bisect_right(starts, t0) - 1
    return i >= 0 and t1 <= ends[i]


def calls_in(lau, name, excluding=()):
    """The enqueuing calls made inside a span "lmpc.<name>" and inside no
    span "lmpc.<x>" for x in `excluding`; None where the window holds no
    span `name`."""
    inside = _intervals(lau.spans, name)
    if not inside[0]:
        return None
    outside = [_intervals(lau.spans, x) for x in excluding]
    return [c for c in lau.calls
            if _inside(c[1], c[2], inside)
            and not any(_inside(c[1], c[2], iv) for iv in outside)]


def device_ms_per_tick(tr, name):
    """Device ms a tick of the operations enqueued inside the spans
    "lmpc.<name>"; None where there are none."""
    lau = of(tr)
    calls = None if lau is None else calls_in(lau, name)
    if calls is None:
        return None
    us = sum(e - s for c in calls for _, s, e in lau.ops.get(c[3], ()))
    return us * 1e-3 / tr.ticks


def launches_per_tick(tr, name, excluding=()):
    """Kernel launches a tick inside the spans "lmpc.<name>" and outside
    those of `excluding`; None where there is no span `name`."""
    lau = of(tr)
    calls = None if lau is None else calls_in(lau, name, excluding)
    if calls is None:
        return None
    return sum(1 for c in calls if LAUNCH.match(c[0])) / tr.ticks
