"""The port's ADMM convex-MPC path at the upstream controller's horizon
(H=30, n=360) against the benchmark's plain reference
(`benchmark/reference/mpc/condensed.py`,
`benchmark/reference/control/condensed_step.py`), in float64 on the CPU
(the plain versions of kernels K4/K5) at B=4 from a seeded random trotting
state: the condensed build alone, the ADMM solve alone cold and warm, one
cold and one warm tick of `closed_loop_tick_batched(..., solver="admm",
horizon=30)` by layer; and the work counts of K4 and K5 at n=360 against
hand sums, and the composition of a solve: one K4, then one K5 and one
ADMM step kernel an iteration (and a step kernel launch before the first,
for its right-hand side)."""

import pytest
import torch

from benchmark import chol_counts, compare, counts
from benchmark.reference import config as ref_config
from benchmark.reference.control import condensed_step
from benchmark.reference.control import step as ref_step
from benchmark.reference.mpc import condensed
from benchmark.reference.mpc import gait as ref_gait
from legged_mpc_control_tpu_torch.config import go1_params
from legged_mpc_control_tpu_torch.control import step
from legged_mpc_control_tpu_torch.mpc import admm, convex_mpc, gait, qp_builder
from legged_mpc_control_tpu_torch.ops import admm_kernel, chol_kernel
from legged_mpc_control_tpu_torch.parallel import runner

B, H, ITERS, RHO = 4, 30, 30, 1e-3
F64 = torch.float64
CPU = "cpu"
SEED = 2 ** 31 + 20
# float64 on both sides; the reference solves with torch.cholesky_solve
# where the port's plain K5 runs two triangular solves
TOL = dict(rtol=1e-9, atol=1e-9)


def _draw(gen, shape, scale):
    return scale * (2.0 * torch.rand(shape, generator=gen, dtype=F64) - 1.0)


@pytest.fixture(scope="module")
def start():
    """(port loop, reference loop, port params, reference params): a
    trotting Go1 batch whose trunk attitude, rates and velocity are drawn
    from the seed, the same state in both packages' containers."""
    gen = torch.Generator().manual_seed(SEED)
    params = go1_params(F64, CPU)
    pb = step.broadcast_params(params, B)
    loop = runner.init_loop_batch(params, B, gen, dtype=F64,
                                  body_height=0.28,
                                  height_range=(0.26, 0.30), device=CPU)
    loop = step.seed_batched_feedback(loop, pb)
    cs = loop.controller
    fbk = cs.fbk.replace(
        root_euler=cs.fbk.root_euler + _draw(gen, (B, 3), 0.05),
        root_ang_vel=cs.fbk.root_ang_vel + _draw(gen, (B, 3), 0.3),
        root_lin_vel=cs.fbk.root_lin_vel + _draw(gen, (B, 3), 0.2))
    cs = cs.replace(
        fbk=fbk,
        ctrl=cs.ctrl.replace(movement_mode=torch.ones((B,),
                                                      dtype=torch.int32)),
        joy=cs.joy.replace(velx=torch.full((B,), 0.15, dtype=F64)))
    loop = loop.replace(controller=cs)
    rparams = ref_config.go1_params(F64, CPU)
    template = ref_step.init_loop_batch(rparams, B,
                                        torch.Generator().manual_seed(0),
                                        dtype=F64)
    rloop = compare.fill(template, compare.leaves(loop))
    return loop, rloop, pb, ref_step.broadcast_params(rparams, B)


@pytest.fixture(scope="module")
def stage(start):
    loop, _, pb, _ = start
    _, st = convex_mpc.mpc_prepare(loop.controller, pb,
                                   gait.trot_pattern(F64, CPU), 0.01,
                                   horizon=H)
    return st


def _build(stage, fn):
    return fn(stage.x0, stage.x_ref, stage.A_seq, stage.B, stage.contact,
              stage.q_weights, stage.r_weights, stage.mu, stage.fz_max, 0.01)


def test_condensed_build_is_the_references(stage):
    port = _build(stage, qp_builder.build_condensed_qp)
    ref = _build(stage, condensed.build_condensed_qp)
    assert port.P.shape == (B, 12 * H, 12 * H)
    for name in ("P", "q", "mu", "fz_max"):
        torch.testing.assert_close(getattr(port, name), getattr(ref, name),
                                   **TOL, msg=name)


def test_a_float32_build_keeps_the_solution(stage):
    """From float32 inputs the build sums P = S^T Q S in float64 and rounds
    it once: the thirty-iteration ADMM solution (in float64) of that QP lies
    within 0.08 N of the float64 build's, where float32 sums put it
    0.12-0.20 N away on this state."""
    f32 = type(stage)(*(v.float() if torch.is_tensor(v)
                        and v.is_floating_point() else v for v in stage))

    def solve(qp):
        qp = type(qp)(*(v.to(F64) for v in qp))
        return condensed.solve_qp_admm_batched(
            qp.P, qp.q, qp.mu, qp.fz_max, qp.contact, iters=ITERS,
            rho=RHO).u

    qp32 = _build(f32, qp_builder.build_condensed_qp)
    assert qp32.P.dtype == torch.float32
    assert torch.equal(qp32.P, qp32.P.transpose(-1, -2))
    err = (solve(qp32) - solve(_build(stage, qp_builder.build_condensed_qp))
           ).abs().amax(-1)
    assert err.max() < 0.08, err


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_admm_solve_is_the_references(stage, warm):
    qp = _build(stage, qp_builder.build_condensed_qp)
    args = (qp.P, qp.q, qp.mu, qp.fz_max, qp.contact)
    w_port = w_ref = None
    if warm:
        w_port = admm.solve_qp_admm_batched(*args, iters=ITERS,
                                            rho=RHO).warm
        w_ref = condensed.solve_qp_admm_batched(*args, iters=ITERS,
                                                rho=RHO).warm
    port = admm.solve_qp_admm_batched(*args, iters=ITERS, rho=RHO,
                                      warm=w_port)
    ref = condensed.solve_qp_admm_batched(*args, iters=ITERS, rho=RHO,
                                          warm=w_ref)
    assert port.u.abs().max() > 10.0        # the stance legs carry the robot
    torch.testing.assert_close(port.u, ref.u, **TOL)
    for a, b in zip(port.warm, ref.warm):
        torch.testing.assert_close(a, b, **TOL)


def _port_tick(loop, pb, warm, monkeypatch):
    """The port's tick and the (B, 12H) solution its ADMM solve returned."""
    solve, kept = admm.solve_qp_admm_batched, {}

    def keep(*args, **kwargs):
        res = solve(*args, **kwargs)
        kept["u"] = res.u
        return res
    monkeypatch.setattr(admm, "solve_qp_admm_batched", keep)
    loop, warm = step.closed_loop_tick_batched(
        loop, pb, gait.trot_pattern(F64, CPU), horizon=H, kf_type=0,
        iters=ITERS, solver="admm", warm=warm, fused_substeps=True,
        carry_feedback=True, admm_rho=RHO)
    monkeypatch.setattr(admm, "solve_qp_admm_batched", solve)
    return loop, warm, kept["u"]


@pytest.mark.parametrize("ticks", [1, 2], ids=["cold", "warm"])
def test_tick_is_the_references(start, monkeypatch, ticks):
    loop, rloop, pb, rpb = start
    warm = rwarm = None
    for _ in range(ticks):
        loop, warm, u = _port_tick(loop, pb, warm, monkeypatch)
        rloop, res = condensed_step.closed_loop_tick_admm_batched(
            rloop, rpb, ref_gait.trot_pattern(F64, CPU), horizon=H,
            iters=ITERS, rho=RHO, warm=rwarm)
        rwarm = res.warm
    torch.testing.assert_close(u, res.u, **TOL)
    prog, ref = compare.leaves(loop), compare.leaves(rloop)
    for layer in ("sim", "controller.fbk", "controller.ctrl"):
        keys = [k for k in prog if k.startswith(layer + ".")]
        assert keys
        for k in keys:
            if prog[k].dtype.is_floating_point:
                torch.testing.assert_close(prog[k], ref[k], **TOL, msg=k)
            else:
                assert torch.equal(prog[k], ref[k]), k
    for a, b in zip(warm, rwarm):
        torch.testing.assert_close(a, b, **TOL)


def test_k4_k5_work_at_n360():
    n, b = 360, 4096
    tri = n * (n + 1) // 2                  # 64,980 floats
    assert chol_counts.tri(n) == tri == 64980
    # K4: reads K's lower triangle, writes F whole; n^3 / 3 a matrix
    assert chol_counts.k4_work(b, n) == (b * 4 * (64980 + 129600),
                                         b * 15552000.0, 0)
    # K5: F's n^2 floats, b and x; 2 n^2 a solve
    assert chol_counts.k5_work(b, n) == (b * 4 * (129600 + 720),
                                         b * 259200, 0)
    t4, by4 = counts.least_time_s(*chol_counts.k4_work(b, n))
    t5, by5 = counts.least_time_s(*chol_counts.k5_work(b, n))
    assert by4 == "bytes" and t4 == pytest.approx(0.9516e-3, rel=1e-3)
    assert by5 == "bytes" and t5 == pytest.approx(0.6374e-3, rel=1e-3)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_admm_solve_launches_per_iteration(stage, monkeypatch, warm):
    """The kernel wrappers a 30-iteration solve calls (each one launch on
    the card): K4 once, K5 30 times, the step kernel 31 times (the first
    right-hand side alone, then an update with the next one after each
    solve)."""
    qp = _build(stage, qp_builder.build_condensed_qp)
    args = (qp.P, qp.q, qp.mu, qp.fz_max, qp.contact)
    start = (admm.solve_qp_admm_batched(*args, iters=ITERS, rho=RHO).warm
             if warm else None)
    calls = []

    def counted(module, name):
        fn = getattr(module, name)

        def wrapper(*a, **kw):
            calls.append((name, a[0] is not None))
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapper)
    for module, name in ((chol_kernel, "cholesky_cuda"),
                         (chol_kernel, "cho_solve_cuda"),
                         (admm_kernel, "admm_step")):
        counted(module, name)
    admm.solve_qp_admm_batched(*args, iters=ITERS, rho=RHO, warm=start)
    step = [c for c in calls if c[0] == "admm_step"]
    assert [c[0] for c in calls[:2]] == ["cholesky_cuda", "admm_step"]
    assert sum(c[0] == "cholesky_cuda" for c in calls) == 1
    assert sum(c[0] == "cho_solve_cuda" for c in calls) == ITERS
    assert [c[0] for c in calls[2:]] == ["cho_solve_cuda",
                                         "admm_step"] * ITERS
    assert [c[1] for c in step] == [False] + [True] * ITERS
