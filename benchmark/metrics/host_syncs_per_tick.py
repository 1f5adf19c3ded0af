"""Synchronizing CUDA API calls a tick inside the program's "lmpc.tick"
spans (stream, device and event synchronizations, synchronous copies):
each drains the launch queue and leaves the card idle while the host
refills it. None for a program without the spans
(`benchmark/program_spans.py`)."""

from benchmark import program_spans


def read(tr):
    side = program_spans.of(tr)
    if side is None:
        return None
    return program_spans.syncs_per_tick(side, tr.ticks)
