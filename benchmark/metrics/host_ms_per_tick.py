"""Host time inside the tick call a tick (ms): the benchmark's own host
clock around each call, summed over the window, over the ticks. The
enqueue cost that a CUDA graph of the tick would cut; measured in the
traced run, under the profiler."""


def read(tr):
    return tr.host_s * 1e3 / tr.ticks
