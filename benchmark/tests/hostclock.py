"""A stand-in for the card's clock in the CPU tests: the harness's window
with host-clock marks, so that a run can be driven end to end without a
card (the benchmark itself refuses to run without one)."""

import time


class HostClock:
    def sync(self):
        pass

    def mark(self):
        return time.perf_counter()

    @staticmethod
    def elapsed_ms(a, b):
        return (b - a) * 1e3
