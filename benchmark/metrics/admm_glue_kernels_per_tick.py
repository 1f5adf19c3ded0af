"""Kernel launches a tick inside the program's "lmpc.admm" spans and
outside its "lmpc.k4" and "lmpc.k5" spans: the ADMM iterations' elementwise
operations and the solve's set-up as torch ops, which a fused ADMM
iteration would remove (`benchmark/launch_spans.py`). None for a program
without those spans."""

from benchmark import launch_spans


def read(tr):
    return launch_spans.launches_per_tick(tr, "admm", ("k4", "k5"))
