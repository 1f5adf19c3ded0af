"""The traced window (`--trace 1`): torch.profiler over the window, with a
span around each layer of the tick, and the arithmetic the per-layer
metrics and the breakdown share.

The spans come from this file: `Profile` wraps the module attributes a
driver names (`Cell.layers()`) in `torch.profiler.record_function` for the
window and restores them after. Every device operation (kernel, copy,
memset) inside the window's span is kept with its start and end; the
device is busy where any of them runs (the union of their intervals, so
that overlap never counts twice)."""

import time
from dataclasses import dataclass, field

WINDOW = "benchmark.window"
# a device operation's name in the breakdown: its first characters (a
# kernel's full name spells out every template argument)
NAME_CHARS = 160


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


@dataclass
class Trace:
    """What a traced window leaves to the per-layer metrics. Times in
    microseconds on the profiler's clock, except where the name says
    seconds. `kernels`: role ("K1", ...) -> (a substring of the kernel's
    name, (bytes, float32 operations, float64 operations) a launch)."""
    ops: list                      # (name, start_us, end_us), device ops
    spans: list                    # (label, start_us, end_us), host spans
    window: tuple                  # (start_us, end_us)
    ticks: int
    host_s: float                  # host time inside the tick calls
    batch: int
    kernels: dict = field(default_factory=dict)
    read_s: float = 0.0

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self):
        return sum(e - s for s, e in union(
            [(s, e) for _, s, e in self.ops])) * 1e-6

    def role_ops(self, role):
        """The device operations of kernel `role`, or [] if the cell does
        not launch it."""
        if role not in self.kernels:
            return []
        pattern = self.kernels[role][0]
        return [op for op in self.ops if pattern in op[0]]

    def glue_ops(self):
        """The device operations that are none of the cell's kernels."""
        patterns = [p for p, _ in self.kernels.values()]
        return [op for op in self.ops
                if not any(p in op[0] for p in patterns)]


def roofline_pct(tr, role):
    """100 x the least time of one launch of kernel `role` (its frozen work
    against the data-sheet peaks) over its mean device time a launch;
    None where the window holds no launch of it."""
    from benchmark import counts

    ops = tr.role_ops(role)
    if not ops:
        return None
    mean_s = sum(e - s for _, s, e in ops) * 1e-6 / len(ops)
    least, _ = counts.least_time_s(*tr.kernels[role][1])
    return 100.0 * least / mean_s


def launch_summary(tr):
    """Each kernel role's launches and their least, median and largest
    device ms."""
    parts = []
    for role in tr.kernels:
        ms = sorted((e - s) * 1e-3 for _, s, e in tr.role_ops(role))
        if ms:
            parts.append(f"{role} {len(ms)} launches, {ms[0]!r} / "
                         f"{ms[len(ms) // 2]!r} / {ms[-1]!r} ms")
    return "; ".join(parts)


def breakdown(tr, n=10):
    """{device_ops: the n device operations that took most time, by name,
    in seconds; idle_gaps: the n longest stretches of the window with
    nothing on the device, each named by the innermost host span open at
    its middle}."""
    by_name = {}
    for name, s, e in tr.ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    busy = union([(s, e) for _, s, e in tr.ops])
    edges = [tr.window[0]] + [x for iv in busy for x in iv] + [tr.window[1]]
    gaps = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = 0.5 * (s + e)
        open_spans = [sp for sp in tr.spans if sp[1] <= mid <= sp[2]]
        label = (min(open_spans, key=lambda sp: sp[2] - sp[1])[0]
                 if open_spans else "outside the tick's spans")
        named.append([label, (e - s) * 1e-6])
    return {"device_ops": [[k[:NAME_CHARS], v] for k, v in ops],
            "idle_gaps": named}


class Profile:
    """Context manager: torch.profiler (host and device) over the window,
    a span around the window and around each of `layers` ((owner, attribute,
    label): the attribute is wrapped while the profile is open)."""

    def __init__(self, layers):
        self.layers = list(layers)
        self.labels = {label for _, _, label in self.layers}

    def __enter__(self):
        import torch

        self._saved = []
        for owner, attr, label in self.layers:
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, _spanned(fn, label))
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._span.__exit__(*exc)
            self.prof.__exit__(*exc)
        finally:
            for owner, attr, fn in reversed(self._saved):
                setattr(owner, attr, fn)
        return False

    def trace(self, window, cell):
        """The Trace of the closed window (`harness.run_window`'s record)."""
        import torch

        t0 = time.perf_counter()
        results = self.prof.profiler.kineto_results
        ops, spans, win = read_events(
            results.events(), results.trace_start_ns(), self.labels,
            torch.autograd.DeviceType.CUDA)
        return Trace(ops=ops, spans=spans, window=win,
                     ticks=window["ticks"], host_s=window["host_s"],
                     batch=cell.batch, kernels=cell.kernels(),
                     read_s=time.perf_counter() - t0)


def read_events(events, t0_ns, labels, device):
    """(device ops in the window, host spans, window) from the profiler's
    raw events, in microseconds after `t0_ns`. A span shows on the host
    and, as an annotation, on the device: the host's is kept."""
    ops, spans, win = [], [], None
    for ev in events:
        name = ev.name()
        s = (ev.start_ns() - t0_ns) * 1e-3
        e = s + ev.duration_ns() * 1e-3
        on_device = ev.device_type() == device
        if name == WINDOW or name in labels:
            if not on_device:
                if name == WINDOW:
                    win = (s, e)
                else:
                    spans.append((name, s, e))
        elif on_device:
            ops.append((name, s, e))
    if win is None:
        raise RuntimeError("the profiler recorded no window span")
    ops = [(n, max(s, win[0]), min(e, win[1])) for n, s, e in ops
           if e > win[0] and s < win[1]]
    if not ops:
        raise RuntimeError("the profiler recorded no device operation in "
                           "the window")
    return ops, spans, win


def _spanned(fn, label):
    import torch

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapped
