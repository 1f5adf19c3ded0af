"""Device time a tick (ms) of the operations the condensed QP's build
launched: every kernel, copy and memset enqueued inside the program's
"lmpc.qp_condense" spans, matched to its launch by the profiler's
correlation id (`benchmark/launch_spans.py`). None for a program without
that span."""

from benchmark import launch_spans


def read(tr):
    return launch_spans.device_ms_per_tick(tr, "qp_condense")
