"""Device time a tick (ms) of every kernel, copy and memset that is none of
the cell's hand-written kernels: MPC prepare, the CI walk's prep and post,
the seam and the feedback, as torch ops."""


def read(tr):
    return sum(e - s for _, s, e in tr.glue_ops()) * 1e-3 / tr.ticks
