"""Per-layer metrics, one module each, found by the metric's name in
`BENCHMARK.json`. Each has `read(trace) -> float or None`: `trace` is the
traced window's `benchmark.tracing.Trace`; None where the window holds
nothing to read, and the harness then leaves the metric out."""
