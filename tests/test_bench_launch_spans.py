"""The benchmark's attribution of device work and launches to the program's
spans by correlation id (`benchmark/launch_spans.py`) and the metrics of
the ADMM cell built on it (`condense_device_ms_per_tick`,
`admm_glue_kernels_per_tick`, `k4_roofline_pct`, `k5_roofline_pct`), on
synthetic event lists and on a B=8 ADMM tick traced on the CPU."""

import pytest
import torch

from benchmark import chol_counts, counts, harness, launch_spans, tracing

WINDOW = (0.0, 3000.0)
METRICS = ("condense_device_ms_per_tick", "admm_glue_kernels_per_tick",
           "k4_roofline_pct", "k5_roofline_pct")


def _metric(name):
    return harness.load_metric(harness.ROOT, name)


class _Ev:
    def __init__(self, name, start_ns, dur_ns, dev, corr=0, linked=0):
        self._v = (name, start_ns, dur_ns, dev, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def test_read_events_pairs_calls_and_device_ops_by_id():
    t0, us = 10 ** 15, 1000
    evs = [_Ev("cudaLaunchKernel", t0 + 100 * us, 5 * us, "cpu", corr=7),
           _Ev("cudaMemsetAsync", t0 + 110 * us, 5 * us, "cpu", corr=8),
           _Ev("aten::mul", t0 + 120 * us, 5 * us, "cpu", corr=9),
           _Ev("cudaLaunchKernel", t0 + 3100 * us, 5 * us, "cpu", corr=10),
           _Ev("gemv_kernel", t0 + 200 * us, 50 * us, "gpu", corr=7),
           _Ev("Memset", t0 + 2990 * us, 50 * us, "gpu", linked=8)]
    calls, ops = launch_spans.read_events(evs, t0, WINDOW, "gpu")
    assert calls == [("cudaLaunchKernel", 100.0, 105.0, 7),
                     ("cudaMemsetAsync", 110.0, 115.0, 8)]
    assert ops == {7: [("gemv_kernel", 200.0, 250.0)],
                   8: [("Memset", 2990.0, 3000.0)]}


def _trace(ticks=2):
    """Two ticks: in each, a condense span with a launch (a 400 us kernel)
    and a memset (20 us), and an ADMM span with three launches of its own
    and one inside each of a K4 and a K5 span."""
    tr = tracing.Trace(ops=[], spans=[], window=WINDOW, ticks=ticks,
                       host_s=0.0, batch=4096)
    spans, calls, ops = [], [], {}
    for t in range(ticks):
        b = 1000.0 * t
        spans += [("lmpc.tick", b, b + 900.0),
                  ("lmpc.qp_condense", b + 10.0, b + 100.0),
                  ("lmpc.admm", b + 100.0, b + 800.0),
                  ("lmpc.k4", b + 200.0, b + 300.0),
                  ("lmpc.k5", b + 400.0, b + 500.0)]
        for i, (name, at, dur) in enumerate((
                ("cudaLaunchKernel", 20.0, 400.0),
                ("cudaMemsetAsync", 30.0, 20.0),
                ("cudaLaunchKernel", 150.0, 5.0),
                ("cuLaunchKernel", 250.0, 900.0),
                ("cudaLaunchKernel", 450.0, 600.0),
                ("cudaLaunchKernel", 600.0, 5.0),
                ("cudaMemsetAsync", 650.0, 5.0),
                ("cudaLaunchKernel", 700.0, 5.0))):
            corr = 100 * t + i
            calls.append((name, b + at, b + at + 1.0, corr))
            ops[corr] = [("op", b + at + 50.0, b + at + 50.0 + dur)]
    tr.host_side = None
    tr.launches = launch_spans.Launches(calls=calls, ops=ops, spans=spans)
    return tr


def test_condense_time_and_admm_glue_launches():
    tr = _trace()
    assert _metric("condense_device_ms_per_tick").read(tr) == pytest.approx(
        0.42)
    # three launches in the ADMM span outside K4 and K5; a memset is no
    # kernel launch
    assert _metric("admm_glue_kernels_per_tick").read(tr) == 3.0
    assert launch_spans.launches_per_tick(tr, "admm") == 5.0


def test_k4_k5_rooflines_from_their_launches():
    n = 360
    tr = tracing.Trace(
        ops=[("chol_factor_large", 0.0, 12000.0),
             ("chol_solve_stream<12>", 12000.0, 13000.0),
             ("chol_solve_stream<12>", 13000.0, 14000.0)],
        spans=[], window=WINDOW, ticks=1, host_s=0.0, batch=4096,
        kernels={"K4": ("chol_factor", chol_counts.k4_work(4096, n)),
                 "K5": ("chol_solve", chol_counts.k5_work(4096, n))})
    k4, k5 = (_metric(m).read(tr) for m in ("k4_roofline_pct",
                                             "k5_roofline_pct"))
    assert k4 == pytest.approx(100 * counts.least_time_s(
        *chol_counts.k4_work(4096, n))[0] / 12e-3)
    assert k5 == pytest.approx(100 * counts.least_time_s(
        *chol_counts.k5_work(4096, n))[0] / 1e-3)


def test_without_the_spans_every_metric_reads_none():
    tr = tracing.Trace(ops=[("k", 0.0, 1.0)], spans=[], window=WINDOW,
                       ticks=1, host_s=0.0, batch=8)
    tr.host_side = None         # a program older than its spans
    for name in METRICS:
        assert _metric(name).read(tr) is None, name
    tr = _trace()
    tr.launches = launch_spans.Launches(
        calls=tr.launches.calls, ops=tr.launches.ops,
        spans=[sp for sp in tr.launches.spans if sp[0] == "lmpc.tick"])
    assert _metric("condense_device_ms_per_tick").read(tr) is None
    assert _metric("admm_glue_kernels_per_tick").read(tr) is None


def test_a_traced_cpu_admm_tick_is_read_from_the_open_profile():
    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.mpc import gait
    from legged_mpc_control_tpu_torch.parallel import runner

    f32, cpu = torch.float32, "cpu"
    params = go1_params(f32, cpu)
    loop = runner.init_loop_batch(params, 8, torch.Generator().manual_seed(0),
                                  dtype=f32, body_height=0.28,
                                  height_range=(0.26, 0.30), device=cpu)
    pb = step.broadcast_params(params, 8)
    loop = step.seed_batched_feedback(loop, pb)
    pattern = gait.trot_pattern(f32, cpu)

    prof = tracing.Profile([])
    with prof:
        warm = None
        for _ in range(2):
            loop, warm = step.closed_loop_tick_batched(
                loop, pb, pattern, horizon=5, iters=3, solver="admm",
                warm=warm, carry_feedback=True, admm_rho=1e-3)
    results = prof.prof.profiler.kineto_results
    (win,) = [(ev.start_ns() - results.trace_start_ns()) * 1e-3
              for ev in results.events() if ev.name() == tracing.WINDOW]
    tr = tracing.Trace(ops=[("k", win, win + 1.0)], spans=[],
                       window=(win, win + 1e9), ticks=2, host_s=0.0,
                       batch=8)
    lau = launch_spans.of(tr)
    names = [sp[0] for sp in lau.spans]
    assert [names.count(f"lmpc.{k}") for k in ("qp_condense", "admm", "k4",
                                                "k5")] == [2, 2, 2, 6]
    # the CPU enqueues nothing on a device: the spans are found, and hold
    # no launch
    assert _metric("condense_device_ms_per_tick").read(tr) == 0.0
    assert _metric("admm_glue_kernels_per_tick").read(tr) == 0.0
