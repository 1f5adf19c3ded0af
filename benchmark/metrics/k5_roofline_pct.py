"""Kernel K5's share of its roofline (%): the least time of one launch (its
frozen work against the H100's data-sheet peaks, `benchmark/counts.py`,
`benchmark/chol_counts.py`) over its mean device time a launch in the
traced window."""

from benchmark import tracing


def read(tr):
    return tracing.roofline_pct(tr, "K5")
