"""The metric arithmetic on synthetic inputs: the rate, the p95 over all
ticks, the device's idle share as a union of intervals, the rooflines and
the breakdown."""

import statistics

import pytest

from benchmark import counts, harness, tracing
from benchmark.tests.hostclock import HostClock


def _load(name):
    return harness.load_metric(harness.ROOT, name)


def test_quantile_is_statistics_inclusive():
    vals = [3.0, 1.0, 7.0, 2.0, 9.0, 4.0, 11.0, 5.0]
    for q in range(1, 20):
        want = statistics.quantiles(vals, n=20, method="inclusive")[q - 1]
        assert harness.quantile(vals, q / 20) == pytest.approx(want)
    assert harness.quantile([5.0], 0.95) == 5.0


def test_p95_is_over_every_tick():
    # 100 ticks of 40 ms and 10 of 80 ms: the p95 sits in the slow tail
    window = {"ticks": 110, "wall_s": 4.8, "tick_ms": [40.0] * 100
              + [80.0] * 10}
    e2e = harness.end_to_end(window, batch=1000, setup_s=7.5,
                             peak_bytes=3 * 2 ** 30)
    assert e2e["tick_ms_p95"] == 80.0
    assert e2e["scenario_ticks_per_s"] == pytest.approx(1000 * 110 / 4.8)
    assert e2e["peak_mem_gib"] == 3.0
    assert e2e["setup_s"] == 7.5


def test_run_window_counts_every_tick():
    class Ticker:
        batch = 4
        n = 0

        def tick(self):
            self.n += 1

    cell = Ticker()
    w = harness.run_window(cell, 0.05, HostClock())
    assert w["ticks"] == cell.n == len(w["tick_ms"]) > 0
    assert w["wall_s"] >= 0.05
    assert sum(w["tick_ms"]) == pytest.approx(w["wall_s"] * 1e3, rel=0.5)


def _trace(ops, spans=(), window=(0.0, 100.0), ticks=2, kernels=None):
    return tracing.Trace(ops=list(ops), spans=list(spans), window=window,
                         ticks=ticks, host_s=0.004, batch=8,
                         kernels=kernels or {})


def test_idle_share_is_a_union_of_intervals():
    # two overlapping operations count once: busy 10..40 and 60..70
    tr = _trace([("a", 10.0, 30.0), ("b", 20.0, 40.0), ("c", 60.0, 70.0)])
    assert tr.busy_s == pytest.approx(40e-6)
    assert tr.window_s == pytest.approx(100e-6)
    assert _load("device_idle_pct").read(tr) == pytest.approx(60.0)


def test_overlap_never_reads_above_full():
    tr = _trace([("a", 0.0, 100.0), ("b", 0.0, 100.0)])
    assert _load("device_idle_pct").read(tr) == pytest.approx(0.0)


def test_roofline_and_glue():
    work = counts.k2_work(8)
    least, _ = counts.least_time_s(*work)
    dur_us = least * 1e6 * 4          # each launch takes 4x its least time
    ops = [("substep_chain_kernel", 0.0, dur_us),
           ("substep_chain_kernel", 50.0, 50.0 + dur_us),
           ("elementwise_kernel", 10.0, 13.0),
           ("Memcpy HtoD", 20.0, 21.0)]
    tr = _trace(ops, kernels={"K2": ("substep_chain_kernel", work)})
    assert _load("k2_roofline_pct").read(tr) == pytest.approx(25.0)
    assert _load("k1_roofline_pct").read(tr) is None
    assert _load("k7_roofline_pct").read(tr) is None
    assert _load("glue_kernels_per_tick").read(tr) == 1.0
    assert _load("glue_device_ms_per_tick").read(tr) == pytest.approx(
        4e-3 / 2)
    assert _load("host_ms_per_tick").read(tr) == pytest.approx(2.0)


def test_breakdown_names_gaps_by_the_innermost_span():
    ops = [("k", 0.0, 10.0), ("k", 30.0, 40.0), ("j", 45.0, 100.0)]
    spans = [("tick", 0.0, 100.0), ("MPC prepare", 12.0, 28.0)]
    bd = tracing.breakdown(_trace(ops, spans))
    assert bd["device_ops"][0] == ["j", pytest.approx(55e-6)]
    assert [g[0] for g in bd["idle_gaps"]] == ["MPC prepare", "tick"]
    assert bd["idle_gaps"][0][1] == pytest.approx(20e-6)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


class _Ev:
    def __init__(self, name, start_ns, dur_ns, dev):
        self._v = (name, start_ns, dur_ns, dev)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]


def test_read_events_keeps_the_window_and_the_host_spans():
    t0 = 10 ** 15
    evs = [_Ev(tracing.WINDOW, t0 + 1000, 100_000, "cpu"),
           _Ev(tracing.WINDOW, t0 + 1000, 100_000, "gpu"),
           _Ev("MPC prepare", t0 + 2000, 5000, "cpu"),
           _Ev("MPC prepare", t0 + 2500, 5000, "gpu"),
           _Ev("aten::mul", t0 + 2100, 100, "cpu"),
           _Ev("kernel_a", t0 + 500, 1000, "gpu"),        # starts before
           _Ev("kernel_b", t0 + 50_000, 2000, "gpu"),
           _Ev("kernel_c", t0 + 200_000, 2000, "gpu")]    # after
    ops, spans, win = tracing.read_events(evs, t0, {"MPC prepare"}, "gpu")
    assert win == (1.0, 101.0)
    assert spans == [("MPC prepare", 2.0, 7.0)]
    assert ops == [("kernel_a", 1.0, 1.5), ("kernel_b", 50.0, 52.0)]
