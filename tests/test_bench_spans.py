"""The benchmark's reading of the program's own spans
(`benchmark/program_spans.py`) and its two metrics, `host_enqueue_ms_per_tick`
and `host_syncs_per_tick`, on synthetic event lists and on a B=8 convex
tick traced on the CPU. The port imports no JAX, nor does this file."""

import pytest
import torch

from benchmark import harness, program_spans, tracing

WINDOW = (0.0, 3000.0)


def _metric(name):
    return harness.load_metric(harness.ROOT, name)


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


def _trace(ops, spans=(), ticks=2):
    return tracing.Trace(ops=list(ops), spans=list(spans), window=WINDOW,
                         ticks=ticks, host_s=0.004, batch=8)


def test_read_events_keeps_host_spans_and_api_calls_in_the_window():
    t0 = 10 ** 15
    us = 1000
    evs = [_Ev("lmpc.tick", t0 + 100 * us, 900 * us, "cpu"),
           _Ev("lmpc.k1", t0 + 200 * us, 100 * us, "cpu"),
           _Ev("lmpc.k1", t0 + 210 * us, 100 * us, "gpu"),   # a device copy
           _Ev("cudaLaunchKernel", t0 + 220 * us, 10 * us, "cpu"),
           _Ev("cuLaunchKernel", t0 + 240 * us, 10 * us, "cpu"),
           _Ev("cudaStreamSynchronize", t0 + 400 * us, 50 * us, "cpu"),
           _Ev("aten::mul", t0 + 250 * us, 10 * us, "cpu"),
           _Ev("cutlass_gemm_kernel", t0 + 300 * us, 10 * us, "gpu"),
           _Ev("lmpc.tick", t0 + 2900 * us, 900 * us, "cpu"),  # runs past
           _Ev("cudaLaunchKernel", t0 + 4000 * us, 10 * us, "cpu")]
    side = program_spans.read_events(evs, t0, WINDOW, "gpu")
    assert side.spans == [("lmpc.tick", 100.0, 1000.0),
                          ("lmpc.k1", 200.0, 300.0)]
    assert [c[0] for c in side.calls] == [
        "cudaLaunchKernel", "cuLaunchKernel", "cudaStreamSynchronize"]
    assert side.ticks() == [("lmpc.tick", 100.0, 1000.0)]


def _side():
    """Two ticks of 1000 us: six launches of 10 us and one of 300 us (290
    us waiting for a slot) in the first, a 200 us stream sync in the second;
    a sync outside both ticks; a nested tick span counted once."""
    spans = [("lmpc.tick", 0.0, 1000.0), ("lmpc.k1", 100.0, 600.0),
             ("lmpc.tick", 1500.0, 2500.0), ("lmpc.tick", 1600.0, 1700.0),
             ("lmpc.ci_solve", 1800.0, 2200.0)]
    calls = [("cudaLaunchKernel", 10.0 + 20 * i, 20.0 + 20 * i)
             for i in range(6)]
    calls += [("cudaLaunchKernel", 200.0, 500.0),
              ("cudaStreamSynchronize", 1900.0, 2100.0),
              ("cudaLaunchKernel", 2300.0, 2310.0),
              ("cudaDeviceSynchronize", 2700.0, 2900.0)]
    return program_spans.HostSide(spans=spans,
                                  calls=sorted(calls, key=lambda c: c[1]))


def test_enqueue_takes_out_syncs_and_queue_waits():
    side = _side()
    assert len(side.ticks()) == 2
    want_us = 2000.0 - 290.0 - 200.0
    assert program_spans.enqueue_ms_per_tick(side, 2) == pytest.approx(
        want_us * 1e-3 / 2)
    assert program_spans.syncs_per_tick(side, 2) == 0.5
    waits = program_spans.waits(side)
    assert [(w[0], program_spans.innermost(side, w[1])) for w in waits] == [
        ("cudaLaunchKernel", "lmpc.k1"),
        ("cudaStreamSynchronize", "lmpc.ci_solve")]


def test_metrics_read_the_attached_side_and_name_gaps_by_it():
    ops = [("k", 0.0, 150.0), ("k", 650.0, 3000.0)]
    tr = _trace(ops, spans=[("tick", 0.0, 1000.0)])
    program_spans.attach(tr, _side())
    assert _metric("host_enqueue_ms_per_tick").read(tr) == pytest.approx(
        0.755)
    assert _metric("host_syncs_per_tick").read(tr) == 0.5
    assert tracing.breakdown(tr)["idle_gaps"][0][0] == "lmpc.k1"


def test_no_program_spans_leaves_the_trace_as_it_was():
    ops = [("k", 0.0, 10.0), ("k", 30.0, 40.0), ("j", 45.0, 100.0)]
    spans = [("tick", 0.0, 100.0), ("MPC prepare", 12.0, 28.0)]
    tr = _trace(ops, spans)
    before = (list(tr.ops), tr.busy_s, tracing.breakdown(tr))
    for name in ("host_enqueue_ms_per_tick", "host_syncs_per_tick"):
        assert _metric(name).read(tr) is None
    assert (tr.ops, tr.busy_s, tracing.breakdown(tr)) == before
    assert tr.spans == spans


def test_a_traced_cpu_tick_is_read_from_the_open_profile():
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
        for _ in range(2):
            loop, _ = step.closed_loop_tick_batched(
                loop, pb, pattern, horizon=5, iters=3, carry_feedback=True)
    results = prof.prof.profiler.kineto_results
    (win,) = [(ev.start_ns() - results.trace_start_ns()) * 1e-3
              for ev in results.events() if ev.name() == tracing.WINDOW]
    tr = tracing.Trace(ops=[("k", win, win + 1.0)], spans=[],
                       window=(win, win + 1e9), ticks=2, host_s=0.0,
                       batch=8)
    enqueue = _metric("host_enqueue_ms_per_tick").read(tr)
    assert enqueue > 0.0
    assert _metric("host_syncs_per_tick").read(tr) == 0.0
    names = {sp[0] for sp in tr.spans}
    assert {"lmpc.tick", "lmpc.mpc_prepare", "lmpc.k1", "lmpc.k2",
            "lmpc.feedback_unpack", "lmpc.mpc_finish"} <= names
    ticks = [sp for sp in tr.spans if sp[0] == "lmpc.tick"]
    assert len(ticks) == 2
    assert enqueue == pytest.approx(
        sum(e - s for _, s, e in ticks) * 1e-3 / 2)
