"""Device operations a tick that are none of the cell's hand-written
kernels (the torch ops' kernels, copies and memsets); fusion moves it."""


def read(tr):
    return len(tr.glue_ops()) / tr.ticks
