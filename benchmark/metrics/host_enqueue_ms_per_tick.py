"""Host time a tick (ms) inside the program's "lmpc.tick" spans, less the
time its CUDA API calls waited on the device there: every synchronizing
call whole, and each launch, copy or memset call's time above the window's
median for its name, the wait for a slot in a full launch queue. The cost
of enqueuing a tick, which a CUDA graph of the tick would cut; None for a
program without the spans (`benchmark/program_spans.py`)."""

from benchmark import program_spans


def read(tr):
    side = program_spans.of(tr)
    if side is None:
        return None
    return program_spans.enqueue_ms_per_tick(side, tr.ticks)
