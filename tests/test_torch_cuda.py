"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc (sm_90a); skipped elsewhere. The machine with
the card has no JAX, so run these without the suite's conftest:

    python -m pytest -o addopts="" --noconftest -m cuda \
        tests/test_torch_cuda.py
"""

import pytest
import torch

from legged_mpc_control_tpu_torch.config import go1_params
from legged_mpc_control_tpu_torch.control import sensors, step
from legged_mpc_control_tpu_torch.mpc import convex_mpc, gait, riccati
from legged_mpc_control_tpu_torch.ops import (
    chol_kernel,
    cuda_build,
    riccati_kernel,
    substep_kernel,
)
from legged_mpc_control_tpu_torch.parallel import runner

pytestmark = pytest.mark.cuda

B = 257                  # not a multiple of the block width: bounds checks
F32 = torch.float32


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _trot(dev, kf_type):
    """A Go1 batch after 20 standing and 10 trotting ticks on the card."""
    params = go1_params(F32, dev)
    pattern = gait.trot_pattern(F32, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    loop = runner.init_loop_batch(params, B, gen, dtype=F32,
                                  body_height=0.28, device=dev)
    loop, _ = runner.make_batched_rollout(
        pattern, n_ticks=30, pdip_iters=4, walk_velx=0.15,
        stand_ticks=20, kf_type=kf_type)(loop, params)
    return loop, step.broadcast_params(params, B), pattern


@pytest.fixture(scope="module")
def trotting(dev):
    return _trot(dev, 0)


@pytest.fixture(scope="module")
def trotting_kf1(dev):
    return _trot(dev, 1)


# H=1 and 10 keep K1's per-stage store in shared memory, 13 and 30 in
# device scratch; B=1 and 5 leave a block with idle warps
@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("batch", [1, 5, B])
@pytest.mark.parametrize("horizon", [1, 10, 13, 30])
def test_riccati_kernel_matches_plain(trotting, start, batch, horizon):
    loop, params, pattern = trotting
    _, stage = convex_mpc.mpc_prepare(loop.controller, params, pattern,
                                      0.01, horizon=horizon)
    args = tuple(x[:batch] for x in (
        stage.x0, stage.x_ref, stage.A_seq, stage.B, stage.contact,
        stage.q_weights, stage.r_weights, stage.mu, stage.fz_max)) + (0.01,)
    warm_u = None
    if start == "warm":
        warm_u = riccati.warm_shift(
            riccati.solve_qp_riccati_batched(*args, iters=15)[0],
            args[4])
    before = cuda_build.LAUNCHES["riccati_ipm"]
    uk, gk, lk = riccati_kernel.solve_qp_riccati_cuda(*args, iters=15,
                                                      warm_u=warm_u)
    assert cuda_build.LAUNCHES["riccati_ipm"] == before + 1
    up, gp, lp = riccati.solve_qp_riccati_batched(*args, iters=15,
                                                  warm_u=warm_u)
    u64 = riccati.solve_qp_riccati_batched(
        *(a.double() if torch.is_tensor(a) else a for a in args), iters=15,
        warm_u=None if warm_u is None else warm_u.double())[0]
    assert bool(torch.isfinite(uk).all()) and bool((gk < 1e-4).all())
    # no farther from float64 than the plain version, over the batch and,
    # for 99 % of the scenarios, scenario by scenario
    e64 = (uk.double() - u64).abs().amax(-1)
    p64 = (up.double() - u64).abs().amax(-1)
    assert float(e64.max()) <= 1.5 * float(p64.max()) + 2e-2
    assert float(torch.quantile(e64 - 1.5 * p64, 0.99)) <= 2e-2
    d = (uk - up).abs().amax(-1)
    if batch == B:
        # the float32 bracket of chip_smoke.py: 99 % within 2e-2 N of the
        # plain version
        assert float(torch.quantile(d.double(), 0.99)) <= 2e-2
    else:
        # too few scenarios for a 1 % tail (the 0.99 quantile is the
        # largest): each within the bracket, or nearer float64 than the
        # plain version is. At H=30, B=5, cold one scenario is 0.10 N
        # from plain, where plain is 0.155 N from float64 and this kernel
        # and its thread-a-scenario predecessor both 0.053 N (PERF.md).
        assert bool(((d <= 2e-2) | (e64 < p64)).all())
    assert lk.shape == lp.shape == (batch, horizon, 4, 6)


def test_riccati_kernel_refuses_float64(dev):
    x = torch.zeros((2, 10, 12), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        riccati_kernel.solve_qp_riccati_cuda(
            x[:, 0], x, x[..., None].expand(2, 10, 12, 12), x[:, :, None],
            x[..., :4], x[0, 0], x[0, 0], 0.3, 180.0, 0.01)


def _chain(state):
    loop, params, pattern = state
    cs, _ = convex_mpc.mpc_tick_batched(loop.controller, params, pattern,
                                        0.01, horizon=10, iters=4)
    sim = loop.sim
    args = (sim.pos, sim.quat, sim.vel, sim.omega, sim.q, sim.dq,
            sim.contact, sim.anchor, cs.ctrl.optimized_state,
            cs.ctrl.optimized_input, cs.ctrl.movement_mode, params.mass,
            params.mu, params.kp_foot, params.kd_foot, params.trunk_inertia,
            params.rho_fix, params.default_foot_pos,
            params.gait_counter_speed, sensors.contact_threshold(params),
            cs.ctrl.root_lin_vel_d_rel)
    return cs, args


def test_substep_kernel_matches_plain(trotting):
    _, args = _chain(trotting)
    got = substep_kernel.substep_chain_cuda(*args, substeps=8, dt=0.00125)
    want = substep_kernel.substep_chain_plain(*args, substeps=8, dt=0.00125)
    assert torch.equal(got["contact"], want["contact"])
    # the one-tick tolerances of tests/test_substep_fused.py
    for name, tol in (("pos", 2e-4), ("quat", 2e-4), ("vel", 2e-3),
                      ("omega", 5e-3), ("q", 2e-3), ("dq", 5e-2),
                      ("anchor", 2e-4), ("q_tgt", 2e-3), ("dq_tgt", 5e-2),
                      ("tau_ff", 1e-2)):
        assert float((got[name] - want[name]).abs().max()) <= tol, name
    assert float((got["fb"] - want["fb"]).abs().max()) <= 0.5


def test_rollout_on_the_card_launches_both_kernels(trotting):
    loop, _, pattern = trotting
    cuda_build.LAUNCHES.clear()
    final, (pos, _) = runner.make_batched_rollout(
        pattern, n_ticks=3, pdip_iters=4, walk_velx=0.15)(
        loop, go1_params(F32, loop.sim.pos.device))
    assert cuda_build.LAUNCHES == {"riccati_ipm": 3, "substep_chain": 3}
    assert bool(torch.isfinite(pos).all())
    assert 0.2 < float(final.sim.pos[:, 2].mean()) < 0.4


def test_substep_kernel_kf1_matches_plain(trotting_kf1):
    """K3: the chain with the in-chain KF, from a settled filter."""
    cs, args = _chain(trotting_kf1)
    kw = dict(substeps=8, dt=0.00125, kf_type=1, kf_x=cs.kf.x, kf_P=cs.kf.P)
    before = cuda_build.LAUNCHES["substep_chain_kf1"]
    got = substep_kernel.substep_chain_cuda(*args, **kw)
    assert cuda_build.LAUNCHES["substep_chain_kf1"] == before + 1
    want = substep_kernel.substep_chain_plain(*args, **kw)
    assert torch.equal(got["contact"], want["contact"])
    for name, tol in (("pos", 2e-4), ("quat", 2e-4), ("vel", 2e-3),
                      ("omega", 5e-3), ("q", 2e-3), ("dq", 5e-2),
                      ("anchor", 2e-4), ("q_tgt", 2e-3), ("dq_tgt", 5e-2),
                      ("tau_ff", 1e-2), ("kf_x", 2e-3)):
        assert float((got[name] - want[name]).abs().max()) <= tol, name
    dP = (got["kf_P"] - want["kf_P"]).abs()
    assert float((dP - 2e-3 * want["kf_P"].abs()).max()) <= 2e-4
    assert float((got["fb"] - want["fb"]).abs().max()) <= 0.5


def _spd(batch, n, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((batch, n, n), generator=gen, device=dev)
    return A @ A.transpose(-1, -2) * 0.05 + 5.0 * torch.eye(n, device=dev)


@pytest.mark.parametrize("batch", [1, 5, B])
@pytest.mark.parametrize("n", [7, 24, 33, 120, 128, 129, 360])
def test_chol_kernels_match_plain(dev, n, batch):
    """K4/K5 against the plain versions by residuals, on each side of K4's
    dispatch (a warp a matrix for n <= 32, a register-tiled block for
    n <= 128, the blocked panel factor above; batches 1 and 5 leave the
    small variant's last block of eight warps ragged). The factor mirrors
    L into its upper triangle."""
    K = _spd(batch, n, dev, n)
    gen = torch.Generator(device=dev).manual_seed(0)
    b = torch.randn((batch, n), generator=gen, device=dev)
    before = (cuda_build.LAUNCHES["chol_factor"],
              cuda_build.LAUNCHES["chol_solve"])
    F = chol_kernel.cholesky_cuda(K)
    x = chol_kernel.cho_solve_cuda(F, b)
    assert (cuda_build.LAUNCHES["chol_factor"],
            cuda_build.LAUNCHES["chol_solve"]) == (before[0] + 1,
                                                   before[1] + 1)
    assert torch.equal(F, F.transpose(-1, -2))
    L = F.double().tril()
    K64 = K.double()
    assert float((L @ L.transpose(-1, -2) - K64).abs().max()
                 / K64.abs().max()) < 1e-5
    r = (K64 @ x.double()[..., None])[..., 0] - b.double()
    assert float(r.abs().max() / b.abs().max()) < 1e-5
    Fp = chol_kernel.cholesky_plain(K)
    assert float((F - Fp).abs().max()) < 1e-4


def test_chol_kernel_non_positive_pivot(dev):
    K = _spd(4, 12, dev, 3)
    K[2, 5, 5] = -1.0
    F = chol_kernel.cholesky_cuda(K)
    finite = torch.isfinite(F.reshape(4, -1)).all(-1).tolist()
    assert finite == [True, True, False, True]


def test_chol_kernels_refuse_float64(dev):
    K = torch.eye(4, dtype=torch.float64, device=dev).expand(2, 4, 4)
    with pytest.raises(TypeError):
        chol_kernel.cholesky_cuda(K)


@pytest.mark.parametrize("solver,iters", [("pdip", 4), ("admm", 10)])
def test_condensed_rollout_launches_the_chol_kernels(trotting, solver,
                                                     iters):
    loop, _, pattern = trotting
    cuda_build.LAUNCHES.clear()
    final, (pos, _) = runner.make_batched_rollout(
        pattern, n_ticks=3, pdip_iters=iters, walk_velx=0.15,
        solver=solver)(loop, go1_params(F32, loop.sim.pos.device))
    factor = 3 * iters if solver == "pdip" else 3
    solves = 2 * factor if solver == "pdip" else 3 * iters
    assert cuda_build.LAUNCHES == {"chol_factor": factor,
                                   "chol_solve": solves, "substep_chain": 3}
    assert bool(torch.isfinite(pos).all())
    assert 0.2 < float(final.sim.pos[:, 2].mean()) < 0.4


def test_kf1_rollout_launches_the_kf1_chain(trotting_kf1):
    loop, _, pattern = trotting_kf1
    cuda_build.LAUNCHES.clear()
    final, (pos, _) = runner.make_batched_rollout(
        pattern, n_ticks=3, pdip_iters=4, walk_velx=0.15, kf_type=1)(
        loop, go1_params(F32, loop.sim.pos.device))
    assert cuda_build.LAUNCHES == {"riccati_ipm": 3, "substep_chain_kf1": 3}
    assert bool(torch.isfinite(final.controller.kf.x).all())
    assert float((final.controller.kf.x[:, 2] - final.sim.pos[:, 2])
                 .abs().mean()) < 0.025


# --- the contact-implicit slice: K6, K7 and the CI dispatch --------------

# (24, 25) is the gain-solve shape of the CI backward pass (X in
# registers); (33, 40) takes the shared-memory variant, two threads' worth
# of columns
@pytest.mark.parametrize("n,m", [(24, 25), (33, 40)])
def test_chol_solve_multi_matches_plain(dev, n, m):
    """K6 against its plain version and by its residual."""
    K = _spd(B, n, dev, 7)
    gen = torch.Generator(device=dev).manual_seed(1)
    R = torch.randn((B, n, m), generator=gen, device=dev)
    F = chol_kernel.cholesky_cuda(K)
    before = cuda_build.LAUNCHES["chol_solve_multi"]
    X = chol_kernel.cho_solve_multi_cuda(F, R)
    assert cuda_build.LAUNCHES["chol_solve_multi"] == before + 1
    Xp = chol_kernel.cho_solve_multi_plain(F, R)
    assert float((X - Xp).abs().max() / Xp.abs().max()) < 1e-5
    r = K.double() @ X.double() - R.double()
    assert float(r.abs().max() / R.abs().max()) < 1e-5
    with pytest.raises(TypeError):
        chol_kernel.cho_solve_multi_cuda(F.double(), R.double())


def test_chol_solves_nonfinite_factor_stays_in_its_matrix(dev):
    """A NaN on one factor's diagonal gives a non-finite solution in that
    matrix alone: K5 at n=120, K6 at n=24, m=25 (the PDIP and CI stage
    guards rely on it)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    for n, m in ((120, None), (24, 25)):
        F = chol_kernel.cholesky_cuda(_spd(5, n, dev, n))
        F[2, n // 2, n // 2] = float("nan")
        if m is None:
            x = chol_kernel.cho_solve_cuda(
                F, torch.randn((5, n), generator=gen, device=dev))
        else:
            x = chol_kernel.cho_solve_multi_cuda(
                F, torch.randn((5, n, m), generator=gen, device=dev))
        finite = torch.isfinite(x.reshape(5, -1)).all(-1).tolist()
        assert finite == [True, True, False, True, True], (n, finite)


def test_chol_solves_exact_redo(dev):
    """A subnormal dividend (a right-hand side starting with one) sends a
    warp from the fast division to its solve with IEEE divisions, a zero
    one does not: K5 at n=120 (staged triangle) and n=360 (streamed rows,
    redone by the ring), K6 at n=24, m=25. The solutions match the plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(5)
    for n, m in ((120, None), (360, None), (24, 25)):
        F = chol_kernel.cholesky_cuda(_spd(4, n, dev, n))
        if m is None:
            b = torch.randn((4, n), generator=gen, device=dev)
            b[1, 0], b[2, 0] = 1e-40, 0.0
            x = chol_kernel.cho_solve_cuda(F, b)
            xp = chol_kernel.cho_solve_plain(F, b)
        else:
            R = torch.randn((4, n, m), generator=gen, device=dev)
            R[1, 0], R[2, 0] = 1e-40, 0.0
            x = chol_kernel.cho_solve_multi_cuda(F, R)
            xp = chol_kernel.cho_solve_multi_plain(F, R)
        assert float((x - xp).abs().max() / xp.abs().max()) < 1e-5, n


@pytest.mark.parametrize("n,m", [(120, None), (360, None), (24, 25)])
def test_chol_solve_divisions_are_ieee(dev, n, m):
    """With a diagonal factor the sweeps are two divisions an element,
    x_i = (b_i / d_i) / d_i (the updates add zeros). Each matrix has its own
    scale, 2^-100 .. 2^60 for b and 2^-30 .. 2^30 for d, and some zeros in
    b, so most matrices take the kernels' fast division throughout and
    those at the extremes (subnormal quotients) their solve with IEEE
    divisions: every x equals the IEEE quotients, as torch divides on the
    card."""
    B = 257
    gen = torch.Generator(device=dev).manual_seed(n)

    def scaled(shape, lo, hi):
        e = torch.randint(lo, hi, (B,) + (1,) * (len(shape) - 1),
                          generator=gen, device=dev)
        jitter = torch.randint(-2, 3, shape, generator=gen, device=dev)
        mant = torch.rand(shape, generator=gen, device=dev) + 1.0
        return torch.ldexp(mant, (e + jitter).float())

    d = scaled((B, n), -30, 31)
    F = torch.diag_embed(d)
    if m is None:
        b = scaled((B, n), -100, 61) * torch.where(
            torch.rand((B, n), generator=gen, device=dev) < 0.5, -1.0, 1.0)
        b[::7, ::5] = 0.0
        x = chol_kernel.cho_solve_cuda(F, b)
        want = b / d / d
    else:
        b = scaled((B, n, m), -100, 61)
        b[::7, ::5] = 0.0
        x = chol_kernel.cho_solve_multi_cuda(F, b)
        want = b / d[..., None] / d[..., None]
    assert bool(torch.isfinite(want).all())
    assert torch.equal(x, want)


def test_chol_solve_variants_agree_bit_for_bit(dev):
    """A factor at an address not 16-byte aligned sends K5 at n=120 to its
    streamed variant and K6 at n=24 to its shared-memory variant: both keep
    the sums' order, so they return the aligned launch's solution bit for
    bit."""
    gen = torch.Generator(device=dev).manual_seed(3)
    for n, m in ((120, None), (24, 25)):
        F = chol_kernel.cholesky_cuda(_spd(9, n, dev, n))
        flat = torch.empty(F.numel() + 1, device=dev)
        F1 = flat[1:].view_as(F)
        F1.copy_(F)
        assert F1.data_ptr() % 16 != 0
        if m is None:
            b = torch.randn((9, n), generator=gen, device=dev)
            x, x1 = (chol_kernel.cho_solve_cuda(f, b) for f in (F, F1))
        else:
            R = torch.randn((9, n, m), generator=gen, device=dev)
            x, x1 = (chol_kernel.cho_solve_multi_cuda(f, R) for f in (F, F1))
        assert torch.equal(x, x1), n


@pytest.mark.parametrize("batch", [1, 3])
def test_chol_solve_ring_any_n(dev, batch):
    """K5 past the streamed variant's n <= 384 (its ring variant, the
    right-hand side in shared memory): residual and plain version."""
    n = 400
    K = _spd(batch, n, dev, n)
    gen = torch.Generator(device=dev).manual_seed(4)
    b = torch.randn((batch, n), generator=gen, device=dev)
    F = chol_kernel.cholesky_cuda(K)
    before = cuda_build.LAUNCHES["chol_solve"]
    x = chol_kernel.cho_solve_cuda(F, b)
    assert cuda_build.LAUNCHES["chol_solve"] == before + 1
    r = (K.double() @ x.double()[..., None])[..., 0] - b.double()
    assert float(r.abs().max() / b.abs().max()) < 1e-5
    xp = chol_kernel.cho_solve_plain(F, b)
    assert float((x - xp).abs().max() / xp.abs().max()) < 1e-5


def _ci_walked(dev, batch, terrain=None, ticks=6, iters=24, horizon=10):
    """An A1 batch walking the CI closed loop for a few ticks on the card,
    and the policy."""
    from legged_mpc_control_tpu_torch.config import a1_params
    from legged_mpc_control_tpu_torch.mpc import ci_mpc, lci_mpc

    params = a1_params(F32, dev)
    walk = ci_mpc.make_ci_walk_policy_batched(params, terrain=terrain,
                                              velx=0.1, iters=iters,
                                              horizon=horizon)
    stand = lci_mpc.make_stand_policy(params)
    gen = torch.Generator(device=dev).manual_seed(3)
    loop = runner.init_loop_batch(params, batch, gen, dtype=F32, device=dev)
    cs = loop.controller
    loop = loop.replace(controller=cs.replace(ctrl=cs.ctrl.replace(
        movement_mode=torch.ones((batch,), dtype=torch.int32, device=dev))))
    lci = lci_mpc.lci_init_batched(batch, F32, walk.warm_init(batch, F32,
                                                              dev),
                                   device=dev)
    for k in range(ticks):
        loop, lci = step.closed_loop_tick_lci_batched(
            loop, lci, params, stand, walk, 0.01 * k, terrain=terrain)
    return loop, lci, params, stand, walk


_CI_ARGS = {}


def _ci_sweeps_args(dev, horizon):
    """K7's arguments in the solve of a walking CI tick, B=64 (cached by
    horizon)."""
    from legged_mpc_control_tpu_torch.mpc import ci_mpc
    from legged_mpc_control_tpu_torch.ops import ci_kernel

    if horizon not in _CI_ARGS:
        loop, lci, params, stand, walk = _ci_walked(dev, 64,
                                                    horizon=horizon)
        seen = {}
        kernel = ci_kernel.ci_sweeps_cuda

        def capture(*a, **kw):
            seen["args"] = (a, kw)
            return kernel(*a, **kw)
        ci_mpc.ci_kernel.ci_sweeps_cuda = capture
        try:
            step.closed_loop_tick_lci_batched(loop, lci, params, stand, walk,
                                              0.1)
        finally:
            ci_mpc.ci_kernel.ci_sweeps_cuda = kernel
        _CI_ARGS[horizon] = seen["args"]
    return _CI_ARGS[horizon]


def _ci_outside(got, want):
    """Scenarios outside the tolerances of tests/test_ci_fused.py."""
    (Uk, Zk, ck), (Up, Zp, cp) = got, want

    def per(x, y):
        return (x - y).abs().reshape(x.shape[0], -1).amax(-1)
    return ((per(50.0 * Uk[..., :12], 50.0 * Up[..., :12]) > 0.5)
            | (per(Uk[..., 12:], Up[..., 12:]) > 2e-2)
            | (per(Zk, Zp) > 2e-3) | ((ck - cp).abs() > 2e-3 * cp.abs()))


# H=12 is the largest horizon the dispatch sends K7; B=1 leaves one block
@pytest.mark.parametrize("horizon", [10, 12])
@pytest.mark.parametrize("batch", [1, 64])
def test_ci_sweeps_matches_plain(dev, batch, horizon):
    """K7 against its plain version on the solve of a walking CI tick, with
    the tolerances of tests/test_ci_fused.py for 99 % of the scenarios."""
    from legged_mpc_control_tpu_torch.ops import ci_kernel

    a, kw = _ci_sweeps_args(dev, horizon)
    a = tuple(x[:batch] if torch.is_tensor(x) and x.dim() and
              x.shape[0] == 64 else x for x in a)
    assert a[1].shape[:2] == (batch, horizon)
    before = cuda_build.LAUNCHES["ci_sweeps"]
    Uk, Zk, ck = ci_kernel.ci_sweeps_cuda(*a, **kw)
    assert cuda_build.LAUNCHES["ci_sweeps"] == before + 1
    plain = ci_kernel.ci_sweeps_plain(*a, **kw)
    assert bool(torch.isfinite(Uk).all()) and bool(torch.isfinite(ck).all())
    assert int(_ci_outside((Uk, Zk, ck), plain).sum()) <= 0.01 * batch
    with pytest.raises(TypeError):
        ci_kernel.ci_sweeps_cuda(*(x.double() if torch.is_tensor(x) else x
                                   for x in a), **kw)


def test_ci_sweeps_all_nonfinite_keeps_nominal(dev):
    """A NaN in scenario 1's input reference at stage 5 makes all its five
    candidates cost NaN: it keeps its nominal (the warm start and its
    rollout, the kernel's own at iters=0) with cost inf, as the plain
    version does; the other scenarios match plain."""
    from legged_mpc_control_tpu_torch.ops import ci_kernel

    a, kw = _ci_sweeps_args(dev, 10)
    ref_zu = a[2].clone()
    ref_zu[1, 5, 24] = float("nan")
    a = a[:2] + (ref_zu,) + a[3:]
    Uk, Zk, ck = ci_kernel.ci_sweeps_cuda(*a, **kw)
    Up, Zp, cp = ci_kernel.ci_sweeps_plain(*a, **kw)
    rollout = ci_kernel.ci_sweeps_cuda(*a, **dict(kw, iters=0))[1]
    assert torch.equal(Up[1], a[1][1]) and bool(torch.isinf(cp[1]))
    assert torch.equal(Uk[1], a[1][1]) and bool(torch.isinf(ck[1]))
    assert torch.equal(Zk[1], rollout[1])
    assert float((Zk[1] - Zp[1]).abs().max()) <= 2e-3
    rest = torch.arange(64, device=dev) != 1
    out = _ci_outside((Uk[rest], Zk[rest], ck[rest]),
                      (Up[rest], Zp[rest], cp[rest]))
    assert int(out.sum()) <= 0.01 * 63


def test_ci_sweeps_refuses_horizon_above_cap(dev):
    """K7 holds a scenario in its block's shared memory: a horizon beyond
    the cap raises ValueError and names it."""
    from legged_mpc_control_tpu_torch.ops import ci_kernel

    a, kw = _ci_sweeps_args(dev, 10)
    cap = ci_kernel.max_horizon()
    assert 12 <= cap < 100
    H = cap + 1

    def stretch(x):                       # stage axis 1 to H stages
        return x[:2, :1].expand(2, H, *x.shape[2:]).contiguous()
    b = (a[0][:2], stretch(a[1]), stretch(a[2]), a[3][:2], stretch(a[4]),
         a[5][:2]) + a[6:9] + (a[9][:2],)
    before = cuda_build.LAUNCHES["ci_sweeps"]
    with pytest.raises(ValueError, match=f"H <= {cap}"):
        ci_kernel.ci_sweeps_cuda(*b, **dict(kw, iters=1))
    assert cuda_build.LAUNCHES["ci_sweeps"] == before


def test_ci_dispatch_launches(dev):
    """Flat ground runs K7 (with K2 for the substeps); a height field runs
    K4 + K6 in every backward stage, and the fused backend refuses it."""
    from legged_mpc_control_tpu_torch.mpc import ci_mpc
    from legged_mpc_control_tpu_torch.sim import terrain as terrain_mod

    loop, lci, params, stand, walk = _ci_walked(dev, 8, ticks=1)
    cuda_build.LAUNCHES.clear()
    step.closed_loop_tick_lci_batched(loop, lci, params, stand, walk, 0.0)
    assert cuda_build.LAUNCHES == {"ci_sweeps": 1, "substep_chain": 1}
    box = terrain_mod.add_box(terrain_mod.flat(3.0, 0.05, F32, dev),
                              (1.3, 0.0), (2.2, 2.0), 0.03)
    loop, lci, params, stand, walk = _ci_walked(dev, 8, terrain=box,
                                                ticks=1, iters=4)
    cuda_build.LAUNCHES.clear()
    step.closed_loop_tick_lci_batched(loop, lci, params, stand, walk, 0.0,
                                      terrain=box)
    assert cuda_build.LAUNCHES == {"chol_factor": 40,
                                   "chol_solve_multi": 40}
    z = torch.zeros((2, 24), device=dev)
    U = torch.zeros((2, 10, 24), device=dev)
    Iw = torch.eye(3, device=dev).expand(2, 3, 3)
    with pytest.raises(ValueError, match="flat-zero"):
        ci_mpc.ci_solve_batched(z, U, torch.zeros((2, 11, 24), device=dev),
                                U, box, 13.0, Iw, 0.3, iters=2,
                                backend="fused")
    with pytest.raises(TypeError):
        ci_mpc.ci_solve_batched(z.double(), U.double(),
                                torch.zeros((2, 11, 24), device=dev,
                                            dtype=torch.float64),
                                U.double(), None, 13.0, Iw.double(), 0.3,
                                iters=2)
