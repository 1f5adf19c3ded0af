"""The host's side of a traced window: the program's own layer spans and
the CUDA API calls, read from the same profile as `benchmark/tracing.py`'s
device operations and on the same clock (microseconds after the profile's
start).

The port names each layer of its tick with a host span "lmpc.<layer>"
(`legged_mpc_control_tpu_torch/utils/trace.py`); "lmpc.tick" is one call
of a tick entry point. Inside it, the host either enqueues work or waits
on the card: a synchronizing call (`SYNC_CALLS`) waits for the whole
queue to drain, and a launch, copy or memset call waits for a free slot
when the launch queue is full. `host_enqueue_ms_per_tick` and
`host_syncs_per_tick` are read from these.

`tracing.Trace` holds the device operations and the spans the benchmark
patches around the cell's layers only, so `of(tr)` reads the rest from the
profile still open in the harness's frame, once a Trace, and adds the
program's spans to `tr.spans`: the breakdown, which the harness reads
after the per-layer metrics, then names each idle gap by the innermost
span open, the program's or a patched one.
A program without these spans leaves the Trace as it was, and `of` gives
None."""

import bisect
import functools
import re
import statistics
import sys
from dataclasses import dataclass

from benchmark import tracing

PREFIX = "lmpc."
TICK = PREFIX + "tick"
# the program's span helper: where it is not loaded, the program has no spans
SPAN_MODULE = "legged_mpc_control_tpu_torch.utils.trace"
# CUDA API calls by name (the runtime's `cuda*`, the low-level `cu*`)
API_CALL = re.compile(r"cuda[A-Z]|cu[A-Z]")
# the calls that return only once the device has caught up
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize",
    "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
    "cudaMemcpyFromSymbol", "cudaMemcpyToSymbol", "cuStreamSynchronize",
    "cuCtxSynchronize", "cuEventSynchronize", "cuMemcpyDtoH_v2",
    "cuMemcpyHtoD_v2", "cuMemcpyDtoD_v2"})
# the calls that enqueue, and wait only for a slot in a full queue
QUEUE_CALL = re.compile(r"cudaLaunch|cuLaunch|cudaMemcpy|cudaMemset"
                        r"|cuMemcpy|cuMemset")


@dataclass
class HostSide:
    """The window's program spans and API calls, each (name, start_us,
    end_us), sorted by start."""
    spans: list
    calls: list

    def ticks(self):
        """The outermost "lmpc.tick" spans."""
        out = []
        for sp in self.spans:
            if sp[0] == TICK and not (out and sp[1] < out[-1][2]):
                out.append(sp)
        return out

    @functools.cached_property
    def _starts(self):
        return [c[1] for c in self.calls]

    def calls_in(self, start, end):
        """The API calls that start and end inside [start, end]."""
        lo = bisect.bisect_left(self._starts, start)
        hi = bisect.bisect_right(self._starts, end)
        return [c for c in self.calls[lo:hi] if c[2] <= end]


def read_events(events, t0_ns, window, device):
    """The HostSide of the window `(start_us, end_us)` from the profiler's
    raw events: the host's events only, not those on `device` (where a
    span's annotation may show too)."""
    spans, calls = [], []
    w0, w1 = window
    for ev in events:
        name = ev.name()
        # most events are aten ops and kernels: one character tells
        first = name[:1]
        if first == "l" and name.startswith(PREFIX):
            out = spans
        elif first == "c" and API_CALL.match(name):
            out = calls
        else:
            continue
        s = (ev.start_ns() - t0_ns) * 1e-3
        e = s + ev.duration_ns() * 1e-3
        if w0 <= s and e <= w1 and ev.device_type() != device:
            out.append((name, s, e))
    spans.sort(key=lambda x: x[1])
    calls.sort(key=lambda x: x[1])
    return HostSide(spans=spans, calls=calls)


def attach(tr, side):
    """Keep `side` on the Trace and add its spans to `tr.spans`."""
    tr.host_side = side
    tr.spans = list(tr.spans) + list(side.spans)
    return side


def _open_profile():
    """The `tracing.Profile` the harness read `tr` from: a local of a
    calling frame."""
    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, tracing.Profile):
                return v
        f = f.f_back
    return None


def of(tr):
    """The HostSide of the traced window `tr`, read once; None where the
    window holds no "lmpc.tick" span or no profile is found, and at once
    where the program has no span helper (a version older than its
    spans)."""
    if not hasattr(tr, "host_side"):
        prof = _open_profile()
        side = None
        if prof is not None and SPAN_MODULE in sys.modules:
            import torch

            results = prof.prof.profiler.kineto_results
            side = read_events(results.events(), results.trace_start_ns(),
                               tr.window, torch.autograd.DeviceType.CUDA)
        if side is None or not side.ticks():
            tr.host_side = None
        else:
            attach(tr, side)
    return tr.host_side


def waits(side):
    """[(name, start, end, waited_us)]: each API call inside a tick span
    that waited on the device: the whole of a synchronizing call, and a
    launch, copy or memset call's time above the window's median for its
    name (the wait for a free slot in a full queue)."""
    by_name = {}
    for name, s, e in side.calls:
        by_name.setdefault(name, []).append(e - s)
    median = {k: statistics.median(v) for k, v in by_name.items()}
    out = []
    for _, ts, te in side.ticks():
        for name, s, e in side.calls_in(ts, te):
            if name in SYNC_CALLS:
                out.append((name, s, e, e - s))
            elif QUEUE_CALL.match(name) and e - s > median[name]:
                out.append((name, s, e, e - s - median[name]))
    return out


def enqueue_ms_per_tick(side, ticks):
    """Host time inside the tick spans less the time their API calls
    waited on the device, in ms a tick."""
    inside = sum(e - s for _, s, e in side.ticks())
    waited = sum(w for *_, w in waits(side))
    return (inside - waited) * 1e-3 / ticks


def syncs_per_tick(side, ticks):
    """Synchronizing API calls inside the tick spans, a tick."""
    return sum(1 for name, *_ in waits(side) if name in SYNC_CALLS) / ticks


def innermost(side, t):
    """The name of the innermost program span open at time `t`, or None."""
    best = None
    for name, s, e in side.spans:
        if s > t:
            break
        if e >= t and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return None if best is None else best[0]
