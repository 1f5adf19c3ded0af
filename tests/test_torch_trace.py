"""The port's layer spans (`utils/trace.py`) on the CPU: with no profiler
`span` is one shared null context; under `torch.profiler` a B=8 convex tick
(Riccati or ADMM) and a B=8 contact-implicit tick emit the layer spans,
each inside the span of the layer that calls it."""

import pytest
import torch

from legged_mpc_control_tpu_torch.config import a1_params, go1_params
from legged_mpc_control_tpu_torch.control import step
from legged_mpc_control_tpu_torch.mpc import ci_mpc, gait, lci_mpc
from legged_mpc_control_tpu_torch.parallel import runner
from legged_mpc_control_tpu_torch.utils import trace

CPU = "cpu"
F32 = torch.float32

# span -> the span it sits in, in each tick
CONVEX = {"mpc_prepare": "tick", "k1": "tick", "mpc_finish": "tick",
          "k2": "tick", "feedback_unpack": "tick"}
CONVEX_UNCARRIED = {"feedback_update": "tick", "mpc_prepare": "tick",
                    "k1": "tick", "mpc_finish": "tick", "k2": "tick"}
ADMM = {"mpc_prepare": "tick", "qp_condense": "tick", "admm": "tick",
        "k4": "admm", "k5": "admm", "mpc_finish": "tick", "k2": "tick",
        "feedback_unpack": "tick"}
CI = {"feedback_update": "tick", "lci_seam": "tick", "ci_prep": "lci_seam",
      "ci_solve": "lci_seam", "k7": "ci_solve", "ci_post": "lci_seam",
      "k2": "tick"}


def _spans(fn):
    """{name without the prefix: [(start_ns, end_ns)]} of the host spans
    `fn()` emits under a CPU profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(trace.PREFIX):
            out.setdefault(ev.name()[len(trace.PREFIX):], []).append(
                (ev.start_ns(), ev.end_ns()))
    return out


def _assert_nested(spans, parents):
    assert set(spans) == set(parents) | {"tick"}, sorted(spans)
    assert len(spans["tick"]) == 1
    for name, parent in parents.items():
        for s, e in spans[name]:
            assert any(ps <= s and e <= pe for ps, pe in spans[parent]), (
                name, parent)


def test_span_off_is_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    off = trace.span(trace.TICK)
    assert off is trace.span(trace.K7)
    with off:
        pass
    assert _spans(lambda: None) == {}


def _enter_all():
    for name in trace.NAMES:
        with trace.span(name):
            pass


def test_span_names_are_the_layers():
    got = _spans(_enter_all)
    assert sorted(got) == sorted(trace.NAMES)
    assert all(len(v) == 1 for v in got.values())


def _convex_loop(batch=8):
    params = go1_params(F32, CPU)
    loop = runner.init_loop_batch(params, batch,
                                  torch.Generator().manual_seed(0),
                                  dtype=F32, body_height=0.28,
                                  height_range=(0.26, 0.30), device=CPU)
    pb = step.broadcast_params(params, batch)
    return loop, pb, gait.trot_pattern(F32, CPU)


@pytest.mark.parametrize("carry", [True, False], ids=["carried", "uncarried"])
def test_convex_tick_spans_nest(carry):
    loop, pb, pattern = _convex_loop()
    if carry:
        loop = step.seed_batched_feedback(loop, pb)

    def tick():
        step.closed_loop_tick_batched(loop, pb, pattern, horizon=5, iters=3,
                                      solver="riccati",
                                      carry_feedback=carry)
    _assert_nested(_spans(tick), CONVEX if carry else CONVEX_UNCARRIED)


def test_admm_tick_spans_nest():
    loop, pb, pattern = _convex_loop()
    loop = step.seed_batched_feedback(loop, pb)

    def tick():
        step.closed_loop_tick_batched(loop, pb, pattern, horizon=5, iters=3,
                                      solver="admm", carry_feedback=True,
                                      admm_rho=1e-3)
    spans = _spans(tick)
    _assert_nested(spans, ADMM)
    # one condensed build, one solve, one factor, one K5 an iteration
    assert {k: len(spans[k]) for k in ("qp_condense", "admm", "k4", "k5")
            } == {"qp_condense": 1, "admm": 1, "k4": 1, "k5": 3}


def test_ci_tick_spans_nest():
    params = a1_params(F32, CPU)
    B = 8
    loop = runner.init_loop_batch(params, B, torch.Generator().manual_seed(1),
                                  dtype=F32, device=CPU)
    cs = loop.controller
    loop = loop.replace(controller=cs.replace(ctrl=cs.ctrl.replace(
        movement_mode=torch.ones_like(cs.ctrl.movement_mode))))
    walk = ci_mpc.make_ci_walk_policy_batched(params, velx=0.1, iters=2,
                                              backend="fused")
    stand = lci_mpc.make_stand_policy(params)
    lci = lci_mpc.lci_init_batched(B, policy_warm=walk.warm_init(B,
                                                                 device=CPU),
                                   device=CPU)
    t = torch.zeros((), dtype=F32)

    def tick():
        step.closed_loop_tick_lci_batched(loop, lci, params, stand, walk, t)
    _assert_nested(_spans(tick), CI)
