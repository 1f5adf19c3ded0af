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


def _trot(dev, kf_type, seed=1):
    """A Go1 batch after 20 standing and 10 trotting ticks on the card."""
    params = go1_params(F32, dev)
    pattern = gait.trot_pattern(F32, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
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


def _riccati_case(state, start, batch, horizon):
    """K1, the plain float32 version and the float64 one on the card
    test's QP (iters=15, cold or warm from the shifted plain solution).
    Asserts one launch, finite forces, gaps under 1e-4 and the float64
    criteria; returns the kernel's and plain's distances to float64, the
    distance between them and both dual sets."""
    loop, params, pattern = state
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
    return e64, p64, (uk - up).abs().amax(-1), lk, lp


# H=1 and 10 keep K1's per-stage store in shared memory, 13 and 30 in
# device scratch; B=1 and 5 leave a block with idle warps
@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("batch", [1, 5, B])
@pytest.mark.parametrize("horizon", [1, 10, 13, 30])
def test_riccati_kernel_matches_plain(trotting, start, batch, horizon):
    e64, p64, d, lk, lp = _riccati_case(trotting, start, batch, horizon)
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


_TROT_SEEDS = {}


# The fixture's recipe from other seeds, each side of K1's float64 factor
# cutoff (H >= 14), both with the store in device scratch. Plain's own 0.99
# quantile to float64 exceeds 2e-2 N there, so the bracket against plain is
# scenario-wise: within 2e-2 N of plain, or nearer float64 than plain.
@pytest.mark.parametrize("start,batch", [("cold", B), ("warm", B),
                                         ("warm", 5)])
@pytest.mark.parametrize("horizon", [13, 30])
@pytest.mark.parametrize("seed", range(2, 9))
def test_riccati_kernel_matches_plain_seeds(dev, seed, horizon, start,
                                            batch):
    if seed not in _TROT_SEEDS:
        _TROT_SEEDS[seed] = _trot(dev, 0, seed)
    e64, p64, d, lk, lp = _riccati_case(_TROT_SEEDS[seed], start, batch,
                                        horizon)
    near = ((d <= 2e-2) | (e64 < p64)).double().mean()
    assert float(near) >= (0.99 if batch == B else 1.0)
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
@pytest.mark.parametrize("n", [7, 18, 24, 33, 120, 128, 129, 360])
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
    want = {"chol_factor": factor, "chol_solve": solves, "substep_chain": 3,
            "condense": 3}
    if solver == "admm":                # a step an iteration, one before
        want["admm_step"] = 3 * (iters + 1)
    assert cuda_build.LAUNCHES == want
    assert bool(torch.isfinite(pos).all())
    assert 0.2 < float(final.sim.pos[:, 2].mean()) < 0.4


def _admm_qp(state):
    """The condensed QP at the ADMM cell's horizon (H=30, n=360) of the
    first 64 scenarios of a trotting state, with per-scenario mu and
    fz_max, built as the cell builds it (the build kernel)."""
    loop, params, pattern = state
    _, stage = convex_mpc.mpc_prepare(loop.controller, params, pattern,
                                      0.01, horizon=30)
    qp = convex_mpc.build_condensed_from_stage(stage, 0.01)
    dev = qp.P.device
    mu = torch.linspace(0.35, 0.9, 64, device=dev)
    fz = torch.linspace(140.0, 250.0, 64, device=dev)
    return qp.P[:64], qp.q[:64], mu, fz, qp.contact[:64]


@pytest.fixture(scope="module")
def admm_qp(trotting):
    return _admm_qp(trotting)


def _admm_solve(args, warm, device, dtype):
    from legged_mpc_control_tpu_torch.mpc import admm

    return admm.solve_qp_admm_batched(
        *(a.to(device, dtype) if a.is_floating_point() else a.to(device)
          for a in args), iters=30, rho=1e-3,
        warm=None if warm is None else tuple(w.to(device, dtype)
                                             for w in warm))


def _admm_bracket(qp, start):
    """solve_qp_admm_batched at n=360, B=64, 30 iterations, rho 1e-3 (the
    ADMM cell's), on the card (K4 once, K5 30 times, the step kernel 31
    times) against the plain float32 solve of the same inputs on the CPU,
    with float64 as the exact reference. The float32 roundings of K4, K5
    and the step differ from the plain versions', and the ill-conditioned
    QP (Hessian eigenvalues 1e-4..62 after scaling) carries any float32
    solve's worst scenario ~0.12-0.18 N from float64. That worst scenario
    is a statistic of the instance: a change of one ulp in some entries
    of P (the build kernel's P against the plain build's) moved the card's
    from 0.131 to 0.214 N and plain's from 0.153 to 0.125 N at trot seed
    1, warm. So over the 64 scenarios the card's solve has to be at least
    as near float64 as plain's in the median (over trot seeds 1-6, cold
    and warm, both builds: 0.043-0.050 N against 0.074-0.080), and its
    worst scenario at most twice plain's (at most 1.71 times there)."""
    warm = None
    if start == "warm":
        warm = _admm_solve(qp, None, qp[0].device, F32).warm
    cuda_build.LAUNCHES.clear()
    got = _admm_solve(qp, warm, qp[0].device, F32)
    assert cuda_build.LAUNCHES == {"chol_factor": 1, "chol_solve": 30,
                                   "admm_step": 31}
    plain = _admm_solve(qp, warm, "cpu", F32)
    exact = _admm_solve(qp, warm, "cpu", torch.float64)
    for a in (got.u, *got.warm):
        assert bool(torch.isfinite(a).all())
    assert float(exact.u.abs().max()) > 10.0
    e_card = (got.u.cpu().double() - exact.u).abs().amax(-1)
    e_plain = (plain.u.double() - exact.u).abs().amax(-1)
    print(f"{start}: |u - u64| card median {float(e_card.median()):.4f} "
          f"max {float(e_card.max()):.4f} N, plain median "
          f"{float(e_plain.median()):.4f} max {float(e_plain.max()):.4f} N;"
          f" card farther in {int((e_card > e_plain).sum())} of 64")
    assert float(e_card.median()) <= float(e_plain.median())
    assert float(e_card.max()) <= 2.0 * float(e_plain.max())


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_admm_solve_on_the_card_matches_plain(admm_qp, start):
    """The bracket of `_admm_bracket` on the trotting fixture's QP."""
    _admm_bracket(admm_qp, start)


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("seed", range(2, 7))
def test_admm_solve_on_the_card_matches_plain_seeds(dev, seed, start):
    """The same bracket on the fixture's recipe from trot seeds 2-6."""
    if seed not in _TROT_SEEDS:
        _TROT_SEEDS[seed] = _trot(dev, 0, seed)
    _admm_bracket(_admm_qp(_TROT_SEEDS[seed]), start)


def test_admm_step_kernel_matches_plain_step(admm_qp):
    """One launch of the step kernel against the plain step's torch
    operations on the card, from the state of a warm solve's tenth
    iteration: within 2e-6 of each output's largest entry (one step of
    float32 roundings: the plain step's cuBLAS products sum with FMAs and
    divide by rho as a product with its reciprocal; a CPU float32 step lies
    1e-7 from float64)."""
    from legged_mpc_control_tpu_torch.ops import admm_kernel

    seen = []
    step_fn = admm_kernel.admm_step

    def keep(*a, **kw):
        if a[0] is not None and len(seen) < 10:
            seen.append((a, kw))
        return step_fn(*a, **kw)
    admm_kernel.admm_step = keep
    try:
        _admm_solve(admm_qp, None, admm_qp[0].device, F32)
    finally:
        admm_kernel.admm_step = step_fn
    a, kw = seen[-1]
    before = cuda_build.LAUNCHES["admm_step"]
    got = admm_kernel.admm_step(*a, **kw)
    want = admm_kernel.admm_step_plain(*a, **kw)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 2e-6 * float(w.abs().max())
    first = admm_kernel.admm_step(None, *a[1:], **kw)
    assert all(f is t for f, t in zip(first[:3], a[1:4]))
    r = admm_kernel.admm_step_plain(None, *a[1:], **kw)[3]
    assert float((first[3] - r).abs().max()) <= 2e-6 * float(r.abs().max())
    assert cuda_build.LAUNCHES["admm_step"] == before + 2
    with pytest.raises(TypeError):
        admm_kernel.admm_step(*(None if t is None else t.double()
                                for t in a), **kw)


# --- the condensed QP's build kernel -------------------------------------

def _ulp32(x):
    """The spacing of float32 at |x| (float64 in, float64 out)."""
    a = x.abs().float()
    return (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double()


@pytest.mark.parametrize("batch,horizon", [(4096, 30), (1, 10)])
def test_condense_kernel_matches_plain(trotting, batch, horizon):
    """The build kernel, one launch, on the trotting batch's QP (its 257
    scenarios repeated up to the ADMM cell's B=4096 at H=30; the first at
    H=10) against the plain build in float64 on the same float32 inputs:
    every P entry within 2 float32 ulps of itself plus 1e-9 of the
    largest, P exactly symmetric, q within relative 1e-6."""
    from legged_mpc_control_tpu_torch.ops import condense_kernel

    loop, params, pattern = trotting
    _, st = convex_mpc.mpc_prepare(loop.controller, params, pattern, 0.01,
                                   horizon=horizon)
    idx = torch.arange(batch, device=st.x0.device) % st.x0.shape[0]
    args = tuple(t[idx] for t in (st.x0, st.x_ref, st.A_seq, st.B,
                                  st.contact, st.q_weights, st.r_weights))
    assert 0.0 < float(args[4].mean()) < 1.0
    before = cuda_build.LAUNCHES["condense"]
    P, q = condense_kernel.condense(*args, 0.01)
    assert cuda_build.LAUNCHES["condense"] == before + 1
    assert P.dtype == q.dtype == F32
    assert torch.equal(P, P.transpose(-1, -2))
    worst = 0.0
    for lo in range(0, batch, 512):    # the float64 build in slices
        P64, q64 = condense_kernel.condense_plain(
            *(t[lo:lo + 512].double() for t in args), 0.01)
        Pk, qk = P[lo:lo + 512].double(), q[lo:lo + 512].double()
        err = (Pk - P64).abs()
        top = P64.abs().amax((-1, -2), keepdim=True)
        worst = max(worst, float((err / _ulp32(P64)).max()))
        assert bool((err <= 2 * _ulp32(P64) + 1e-9 * top).all())
        torch.testing.assert_close(qk, q64, rtol=1e-6,
                                   atol=1e-9 * float(q64.abs().max()))
        del P64, q64, Pk, err
    print(f"B={batch} H={horizon}: max |P - P64| {worst:.3f} float32 ulps")


def test_condense_allocates_p_and_q_only(trotting):
    """At the ADMM cell's shape (B=4096, H=30, n=360) the build through
    `build_condensed_from_stage` allocates P and q and nothing of their
    size besides: the device memory's peak rises by P's and q's bytes
    plus less than a tenth of P's."""
    loop, params, pattern = trotting
    _, st = convex_mpc.mpc_prepare(loop.controller, params, pattern, 0.01,
                                   horizon=30)
    idx = torch.arange(4096, device=st.x0.device) % st.x0.shape[0]
    st = type(st)(*(t[idx] for t in st))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    qp = convex_mpc.build_condensed_from_stage(st, 0.01)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    pq = (qp.P.numel() + qp.q.numel()) * 4
    assert qp.P.shape == (4096, 360, 360)
    print(f"peak rise {rise / 2 ** 20:.1f} MiB, P and q {pq / 2 ** 20:.1f} "
          f"MiB")
    assert pq <= rise < pq + 0.1 * qp.P.numel() * 4


def test_condense_dispatch(dev):
    """CUDA float32 up to H=64 takes the kernel, CPU tensors the plain
    build (no launch); CUDA float64 and H=65 raise ValueError naming the
    limit, with no launch."""
    from legged_mpc_control_tpu_torch.ops import condense_kernel

    assert condense_kernel.max_horizon() == 64
    gen = torch.Generator(device=dev).manual_seed(5)

    def case(H, dtype):
        r = lambda *s: torch.rand(s, generator=gen, device=dev, dtype=dtype)
        return (r(2, 12), r(2, H, 12), r(2, H, 12, 12), r(2, 12, 12),
                (r(2, H, 4) < 0.5).to(dtype), r(12) + 0.5, r(12) + 0.5)
    for H, dtype, to, launches in ((64, F32, dev, 1), (65, F32, "cpu", 0),
                                   (8, torch.float64, "cpu", 0)):
        before = cuda_build.LAUNCHES["condense"]
        P, q = condense_kernel.condense(*(t.to(to) for t in case(H, dtype)),
                                        0.01)
        assert cuda_build.LAUNCHES["condense"] == before + launches
        assert P.shape == (2, 12 * H, 12 * H) and P.dtype == dtype
        assert P.device.type == torch.device(to).type
        assert bool(torch.isfinite(P).all()) and bool(torch.isfinite(q).all())
    for H, dtype, limit in ((65, F32, "largest, 64"),
                            (8, torch.float64, "float32")):
        before = cuda_build.LAUNCHES["condense"]
        with pytest.raises(ValueError, match=limit):
            condense_kernel.condense(*case(H, dtype), 0.01)
        assert cuda_build.LAUNCHES["condense"] == before


def test_condense_kernel_keeps_the_admm_solution(trotting):
    """The bracket of tests/test_torch_admm_h30.py for a float32 build: the
    thirty-iteration ADMM solution (rho 1e-3, in float64) of the QP the
    kernel builds from float32 inputs at H=30 lies within 0.08 N of the
    float64 build's (the plain one, on the CPU), on the first 64 trotting
    scenarios."""
    from legged_mpc_control_tpu_torch.mpc import admm, qp_builder

    loop, params, pattern = trotting
    _, st = convex_mpc.mpc_prepare(loop.controller, params, pattern, 0.01,
                                   horizon=30)
    st = type(st)(*(t[:64] for t in st))
    before = cuda_build.LAUNCHES["condense"]
    qp32 = convex_mpc.build_condensed_from_stage(st, 0.01)
    assert cuda_build.LAUNCHES["condense"] == before + 1
    qp64 = qp_builder.build_condensed_qp(
        *(t.to("cpu", torch.float64) for t in st), 0.01)

    def solve(qp):
        qp = type(qp)(*(t.to("cpu", torch.float64) for t in qp))
        return admm.solve_qp_admm_batched(qp.P, qp.q, qp.mu, qp.fz_max,
                                          qp.contact, iters=30, rho=1e-3).u
    u64 = solve(qp64)
    err = (solve(qp32) - u64).abs().amax(-1)
    print(f"max |u(kernel build) - u(float64 build)| {float(err.max()):.4f}"
          f" N of {float(u64.abs().max()):.1f} N")
    assert float(u64.abs().max()) > 10.0
    assert float(err.max()) < 0.08, err


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


def test_terrain_tick_launches_k1_only(dev):
    """BASELINE config 4's tick: on a height field the batched tick takes
    the per-substep loop, so K1 runs once a tick and K2 never."""
    from legged_mpc_control_tpu_torch.config import a1_params
    from legged_mpc_control_tpu_torch.sim import srb_sim
    from legged_mpc_control_tpu_torch.sim import terrain as terrain_mod

    params = a1_params(F32, dev)
    box = terrain_mod.add_box(terrain_mod.flat(3.0, 0.05, F32, dev),
                              (1.3, 0.0), (2.2, 2.0), 0.03)
    gen = torch.Generator(device=dev).manual_seed(0)
    loop = runner.init_loop_batch(params, 8, gen, dtype=F32, device=dev)
    loop = loop.replace(sim=srb_sim.sim_init(params, loop.sim.pos[:, 2],
                                             F32, dev, terrain=box))
    pattern = gait.named_pattern("standing_trot", F32, dev)
    pb = step.broadcast_params(params, 8)
    warm = None
    cuda_build.LAUNCHES.clear()
    for _ in range(3):
        loop, warm = step.closed_loop_tick_batched(
            loop, pb, pattern, horizon=30, iters=12, terrain=box, warm=warm)
    assert cuda_build.LAUNCHES == {"riccati_ipm": 3}
    assert bool(torch.isfinite(loop.sim.pos).all())
    assert bool(torch.isfinite(warm).all())


def test_single_robot_tick_on_the_card(dev):
    """The single-robot tick (a batch of one): the condensed PDIP on K4 and
    K5 at B=1, 15 iterations a tick, and the per-substep loop."""
    from legged_mpc_control_tpu_torch.config import a1_params
    from legged_mpc_control_tpu_torch.sim import srb_sim

    params = a1_params(F32, dev)
    pattern = gait.trot_pattern(F32, dev)
    loop = step.LoopState(
        controller=step.controller_init(params, 1, F32, dev),
        sim=srb_sim.sim_init(params, torch.full((1,), 0.3), F32, dev))
    cuda_build.LAUNCHES.clear()
    for k in range(6):
        if k == 3:
            cs = loop.controller
            loop = loop.replace(controller=cs.replace(
                ctrl=cs.ctrl.replace(movement_mode=torch.ones_like(
                    cs.ctrl.movement_mode)),
                joy=cs.joy.replace(velx=torch.full_like(cs.joy.velx,
                                                        0.25))))
        loop = step.closed_loop_tick(loop, params, pattern)
    assert cuda_build.LAUNCHES == {"chol_factor": 6 * 15,
                                   "chol_solve": 6 * 30, "condense": 6}
    assert bool(torch.isfinite(loop.sim.pos).all())
    assert bool(torch.isfinite(loop.controller.ctrl.optimized_input).all())
    assert 0.2 < float(loop.sim.pos[0, 2]) < 0.4


# --- the articulated twin, kf_type 2 and the WBC -------------------------

def _wb_batch(dev, batch, seed=0):
    from legged_mpc_control_tpu_torch.config import a1_params
    from legged_mpc_control_tpu_torch.models import whole_body as wb

    params = a1_params(F32, dev).replace(
        kp_foot=torch.full((3,), 40.0, device=dev),
        kd_foot=torch.full((3,), 1.2, device=dev))
    model = wb.a1_wb_model(F32, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    loop = runner.init_wb_loop_batch(params, model, batch, gen, dtype=F32,
                                     device=dev)
    return loop, params, model


def test_chol_kernels_on_the_twins_mass_matrices(dev):
    """K4 + K5 at n=18, B=256 on the twin's own mass matrices (CRBA plus
    armature, at seeded joint angles about the standing pose) against
    their plain versions, elementwise."""
    from legged_mpc_control_tpu_torch.models import whole_body_b as wbb
    from legged_mpc_control_tpu_torch.sim import wb_sim

    loop, _, model = _wb_batch(dev, 256)
    gen = torch.Generator(device=dev).manual_seed(3)
    q = loop.sim.q + 0.2 * torch.randn(loop.sim.q.shape, generator=gen,
                                       device=dev)
    M = wbb.mass_matrix_b(q, model) + torch.diag(torch.cat([
        torch.zeros(6, device=dev),
        torch.full((12,), wb_sim.ARMATURE, device=dev)]))
    b = torch.randn((256, 18), generator=gen, device=dev)
    F = chol_kernel.cholesky_cuda(M)
    x = chol_kernel.cho_solve_cuda(F, b)
    Fp = chol_kernel.cholesky_plain(M)
    xp = chol_kernel.cho_solve_plain(Fp, b)
    assert float((F - Fp).abs().max() / Fp.abs().max()) < 1e-5
    assert float((x - xp).abs().max() / xp.abs().max()) < 1e-4
    assert float((x - chol_kernel.cho_solve_plain(F, b)).abs().max()
                 / xp.abs().max()) < 1e-5


def test_wb_batched_tick_launches_k1_k4_k5(dev):
    """One batched tick of the twin: K1 once, K4 and K5 32 times each (8
    substeps x n_inner 4), no substep chain."""
    loop, params, model = _wb_batch(dev, 64)
    pattern = gait.trot_pattern(F32, dev)
    pb = step.broadcast_params(params, 64)
    cuda_build.LAUNCHES.clear()
    loop, warm = step.closed_loop_tick_wb_batched(loop, pb, pattern, model,
                                                  horizon=10, iters=8)
    assert cuda_build.LAUNCHES == {"riccati_ipm": 1, "chol_factor": 32,
                                   "chol_solve": 32}
    assert bool(torch.isfinite(loop.sim.q).all())
    assert 0.2 < float(loop.sim.q[:, 2].mean()) < 0.35


def test_kf2_rollout_launches_k1_only(trotting):
    loop, _, pattern = trotting
    cuda_build.LAUNCHES.clear()
    final, _ = runner.make_batched_rollout(
        pattern, n_ticks=3, pdip_iters=4, walk_velx=0.15, kf_type=2)(
        loop, go1_params(F32, loop.sim.pos.device))
    assert cuda_build.LAUNCHES == {"riccati_ipm": 3}
    assert bool(torch.isfinite(final.controller.ekf.x).all())


def test_wbc_twin_tick_on_the_card(dev):
    """One robot on the twin with the WBC: the condensed PDIP's K4 and K5
    at n=120 (15 and 30 a tick) and the twin's at n=18 (32 each a tick)."""
    loop, params, model = _wb_batch(dev, 1)
    pattern = gait.trot_pattern(F32, dev)
    cuda_build.LAUNCHES.clear()
    for _ in range(2):
        loop = step.closed_loop_tick_wb(loop, params, pattern, model,
                                        low_level_type=1)
    assert cuda_build.LAUNCHES == {"chol_factor": 2 * (15 + 32),
                                   "chol_solve": 2 * (30 + 32),
                                   "condense": 2}
    assert bool(torch.isfinite(loop.sim.q).all())
    assert bool(torch.isfinite(loop.controller.ctrl.joint_tau_tgt).all())


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


def _ci_sweeps_args(dev, horizon, batch=64):
    """K7's arguments in the solve of a walking CI tick, B=64 or `batch`
    (cached by horizon and batch)."""
    from legged_mpc_control_tpu_torch.mpc import ci_mpc
    from legged_mpc_control_tpu_torch.ops import ci_kernel

    if (horizon, batch) not in _CI_ARGS:
        loop, lci, params, stand, walk = _ci_walked(dev, batch,
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
        _CI_ARGS[horizon, batch] = seen["args"]
    return _CI_ARGS[horizon, batch]


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


def _bits(x):
    return x.view(torch.int32)


# past one wave of the latency variant (264 scenarios on an H100 at H=10)
K7_BATCH = 1024


@pytest.mark.parametrize("case", ["h10", "h12", "nonfinite_h10"])
def test_ci_sweeps_batch_equals_latency(dev, case):
    """K7's batch variant bit for bit its latency variant (U, Z and cost),
    both launched through their C entries on the solve of a walking CI tick
    of B=1024, at H=10 and H=12, and the batch variant against the plain
    version with the tolerances of tests/test_ci_fused.py for 99 % of the
    scenarios; the non-finite case puts a NaN into scenario 1's input
    reference at stage 5, and both keep its nominal with cost inf."""
    from legged_mpc_control_tpu_torch.ops import ci_kernel

    horizon = 12 if case == "h12" else 10
    a, kw = _ci_sweeps_args(dev, horizon, K7_BATCH)
    if case.startswith("nonfinite"):
        ref_zu = a[2].clone()
        ref_zu[1, 5, 24] = float("nan")
        a = a[:2] + (ref_zu,) + a[3:]
    prepared = ci_kernel._prepare(*a, **kw)
    lib = ci_kernel._lib()
    want = ci_kernel._run(lib.ci_sweeps_launch, prepared)
    got = ci_kernel._run(lib.ci_sweeps_batch_launch, prepared)
    for x, y in zip(got, want):
        assert torch.equal(_bits(x), _bits(y))
    U, Z, cost = got
    plain = ci_kernel.ci_sweeps_plain(*a, **kw)
    rest = torch.arange(K7_BATCH, device=dev)
    if case.startswith("nonfinite"):
        assert torch.equal(U[1], a[1][1]) and bool(torch.isinf(cost[1]))
        assert torch.equal(plain[0][1], a[1][1])
        rest = rest[rest != 1]
        assert bool(torch.isfinite(cost[rest]).all())
    else:
        assert bool(torch.isfinite(U).all()) and bool(
            torch.isfinite(cost).all())
    out = _ci_outside(tuple(x[rest] for x in got),
                      tuple(x[rest] for x in plain))
    assert int(out.sum()) <= 0.01 * len(rest)


def test_ci_sweeps_dispatch_batch_variant(dev):
    """`ci_sweeps_cuda` takes the batch variant past the latency variant's
    one wave (B=1024) and the latency variant at B=64; both count one K7
    launch, the first also one under "ci_sweeps_batch"."""
    from legged_mpc_control_tpu_torch.ops import ci_kernel

    a, kw = _ci_sweeps_args(dev, 10, K7_BATCH)
    lat, bat, sms = ci_kernel.residency(dev.index, 10)
    assert bat > lat and 64 <= lat * sms < K7_BATCH
    for batch, batch_launches in ((K7_BATCH, 1), (64, 0)):
        sub = tuple(x[:batch] if torch.is_tensor(x) and x.dim() and
                    x.shape[0] == K7_BATCH else x for x in a)
        before = dict(cuda_build.LAUNCHES)
        ci_kernel.ci_sweeps_cuda(*sub, **kw)
        assert (cuda_build.LAUNCHES["ci_sweeps"]
                == before.get("ci_sweeps", 0) + 1)
        assert (cuda_build.LAUNCHES["ci_sweeps_batch"]
                == before.get("ci_sweeps_batch", 0) + batch_launches)


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


# --- the rest of the contact-implicit MPC: the wall lean, the LCI walk ---

def _lean(dev, iters=4):
    """tests/test_ci_wall_lean.py's A1 lean on the card: the policy, the
    twin's state at the lean pose (front feet 1.5 mm short of the wall at
    x = 0.35, pitch -0.4) in mode 1 with the 2-tap filter warmed, and the
    LCI state."""
    from legged_mpc_control_tpu_torch.config import a1_params
    from legged_mpc_control_tpu_torch.models import kinematics as kin
    from legged_mpc_control_tpu_torch.models import whole_body as wb
    from legged_mpc_control_tpu_torch.mpc import ci_mpc, lci_mpc
    from legged_mpc_control_tpu_torch.sim import terrain as terrain_mod
    from legged_mpc_control_tpu_torch.sim import wb_sim

    params = a1_params(F32, dev).replace(mu=torch.tensor(0.6, device=dev))
    model = wb.a1_wb_model(F32, dev)
    wall = terrain_mod.wall_at_x(0.35, F32, dev)
    pos = torch.tensor([0.0, 0.0, 0.32], device=dev)
    eul = torch.tensor([0.0, -0.4, 0.0], device=dev)
    tgt = torch.tensor([[0.35, 0.13, 0.42], [0.35, -0.13, 0.42],
                        [-0.17, 0.13, 0.0], [-0.17, -0.13, 0.0]], device=dev)
    feet = tgt.clone()
    feet[0:2, 0] -= 0.0015
    cp, sp = torch.cos(eul[1]), torch.sin(eul[1])
    zero, one = torch.zeros((), device=dev), torch.ones((), device=dev)
    R = torch.stack([torch.stack([cp, zero, sp]), torch.stack([zero, one,
                                                                zero]),
                     torch.stack([-sp, zero, cp])])
    qj = kin.ik_legs((feet - pos) @ R, torch.tensor(
        [0.0, 0.8, -1.6], device=dev).expand(4, 3), wb_sim.wb_rho_fix(model))
    q = torch.cat([pos, eul, qj.reshape(12)])[None]
    fp = wb.foot_positions(q, model)
    sim = wb_sim.WbSimState(q=q, v=torch.zeros_like(q),
                            anchor=fp[..., :2].clone(), wall_anchor=fp,
                            f_contact=torch.zeros_like(fp),
                            last_acc=torch.zeros((1, 3), device=dev))
    cs = step.controller_init(params, 1, F32, dev)
    cs = cs.replace(ctrl=cs.ctrl.replace(movement_mode=torch.ones(
        (1,), dtype=torch.int32, device=dev)))
    lean = ci_mpc.make_ci_lean_policy(params, wall, tgt, pos, eul,
                                      iters=iters)
    lci = lci_mpc.lci_init(F32, lean.warm_init(F32, dev), device=dev)
    lci = lci.replace(prev_foot_pos=(feet - pos)[None],
                      prev_foot_vel=torch.zeros((1, 4, 3), device=dev))
    return dict(params=params, model=model, wall=wall, lean=lean,
                stand=lci_mpc.make_stand_policy(params),
                loop=step.LoopState(controller=cs, sim=sim), lci=lci,
                pose=(tgt, pos, eul))


def _captured_gain_systems(fn):
    """The (A, R) pairs that `fn()` hands K4 + K6, in call order."""
    seen = []
    factor = chol_kernel.cholesky_cuda
    solve = chol_kernel.cho_solve_multi_cuda

    def cap_factor(A):
        seen.append([A.clone()])
        return factor(A)

    def cap_solve(F, R):
        seen[-1].append(R.clone())
        return solve(F, R)
    chol_kernel.cholesky_cuda = cap_factor
    chol_kernel.cho_solve_multi_cuda = cap_solve
    try:
        fn()
    finally:
        chol_kernel.cholesky_cuda = factor
        chol_kernel.cho_solve_multi_cuda = solve
    return seen


def test_ci_wall_lean_tick_launches(dev):
    """One tick of the lean on the twin at 4 sweeps: K4 + K6 in every
    backward stage of the wall solve (40 each, n=24), K4 + K5 on the
    twin's mass matrices (32 each, n=18), no K7."""
    L = _lean(dev)
    cuda_build.LAUNCHES.clear()
    loop, lci = step.closed_loop_tick_lci_wb(
        L["loop"], L["lci"], L["params"], L["model"], L["stand"], L["lean"],
        0.0, wall=L["wall"])
    assert cuda_build.LAUNCHES == {"chol_factor": 40 + 32,
                                   "chol_solve_multi": 40,
                                   "chol_solve": 32}
    assert bool(torch.isfinite(loop.sim.q).all())
    assert float(lci.policy_warm["valid"]) == 1.0


@pytest.mark.parametrize("batch", [1, 16])
def test_ci_wall_gain_systems_k4_k6(dev, batch):
    """K4 + K6 on the wall branch's own stage systems (Quu + Rr, [Qu | Qux
    + Rx]) of a lean solve from seeded states about the lean pose,
    against the plain versions: K6 on K4's factor elementwise, the path
    by its backward error."""
    from legged_mpc_control_tpu_torch.mpc import ci_mpc

    L = _lean(dev)
    tgt, pos, eul = L["pose"]
    p = L["params"]
    gen = torch.Generator(device=dev).manual_seed(batch)
    z0 = torch.cat([pos, eul, torch.zeros(6, device=dev), tgt.reshape(12)])
    z0 = z0 + 0.003 * torch.randn((batch, 24), generator=gen, device=dev)
    rz, ru, U0 = ci_mpc.make_ci_lean_reference(z0, L["wall"], tgt, pos, eul,
                                               p, None)
    seen = _captured_gain_systems(lambda: ci_mpc.ci_solve_batched(
        z0, U0, rz, ru, None, p.mass, p.trunk_inertia.expand(batch, 3, 3),
        p.mu, iters=4, wall=L["wall"], backend="lanes"))
    assert len(seen) == 40
    for A, R in seen[::7]:
        F = chol_kernel.cholesky_cuda(A)
        X = chol_kernel.cho_solve_multi_cuda(F, R)
        Xp = chol_kernel.cho_solve_multi_plain(F, R)
        assert bool(torch.isfinite(X).all())
        assert float(((X - Xp).abs().amax((-1, -2))
                      / Xp.abs().amax((-1, -2))).max()) < 1e-3
        A64 = A.double()
        r = (A64 @ X.double() - R.double()).abs().amax((-1, -2))
        scale = A64.abs().sum(-1).amax(-1) * X.double().abs().amax((-1, -2))
        assert float((r / scale).max()) < 1e-5


def test_lci_walk_tick_chol_n96(dev):
    """The `--mpc lci` walk (`make_walk_policy`, H=8, 12 PDIP iterations)
    on one robot: K4 12 and K5 24 times a tick at n=96, B=1, no other
    kernel; K4 + K5 on the walk's own Newton matrices against plain."""
    from legged_mpc_control_tpu_torch.config import a1_params
    from legged_mpc_control_tpu_torch.mpc import lci_mpc
    from legged_mpc_control_tpu_torch.sim import srb_sim

    params = a1_params(F32, dev)
    loop = step.LoopState(
        controller=step.controller_init(params, 1, F32, dev),
        sim=srb_sim.sim_init(params, torch.full((1,), 0.3), F32, dev))
    lci = lci_mpc.lci_init(F32, device=dev)
    stand = lci_mpc.make_stand_policy(params)
    walk = lci_mpc.make_walk_policy(params)
    seen = []
    factor = chol_kernel.cholesky_cuda

    def cap(K):
        seen.append(K.clone())
        return factor(K)
    cuda_build.LAUNCHES.clear()
    chol_kernel.cholesky_cuda = cap
    try:
        for k in range(3):
            loop, lci = step.closed_loop_tick_lci(loop, lci, params, stand,
                                                  walk, 0.01 * k)
    finally:
        chol_kernel.cholesky_cuda = factor
    assert cuda_build.LAUNCHES == {"chol_factor": 3 * 12,
                                   "chol_solve": 3 * 24, "condense": 3}
    assert all(K.shape == (1, 96, 96) for K in seen)
    gen = torch.Generator(device=dev).manual_seed(2)
    for K in seen[::5]:
        b = torch.randn((1, 96), generator=gen, device=dev)
        F = chol_kernel.cholesky_cuda(K)
        x = chol_kernel.cho_solve_cuda(F, b)
        L = F.double().tril()
        K64 = K.double()
        assert float((L @ L.mT - K64).abs().max() / K64.abs().max()) < 1e-5
        r = (K64 @ x.double()[..., None])[..., 0] - b.double()
        xp = chol_kernel.cho_solve_plain(chol_kernel.cholesky_plain(K), b)
        rp = (K64 @ xp.double()[..., None])[..., 0] - b.double()
        assert float(r.abs().max()) <= 4 * float(rp.abs().max()) + 1e-6
    assert bool(torch.isfinite(loop.sim.pos).all())


def test_single_robot_ci_walk_launches_k7(dev):
    """The single-robot flat CI walk (`make_ci_walk_policy`, 32 sweeps) on
    the SRB tick: K7 once a tick at B=1, the per-substep loop (no K2)."""
    from legged_mpc_control_tpu_torch.config import a1_params
    from legged_mpc_control_tpu_torch.mpc import ci_mpc, lci_mpc
    from legged_mpc_control_tpu_torch.sim import srb_sim

    params = a1_params(F32, dev)
    walk = ci_mpc.make_ci_walk_policy(params, velx=0.1)
    loop = step.LoopState(
        controller=step.controller_init(params, 1, F32, dev),
        sim=srb_sim.sim_init(params, torch.full((1,), 0.3), F32, dev))
    lci = lci_mpc.lci_init(F32, walk.warm_init(F32, dev), device=dev)
    cuda_build.LAUNCHES.clear()
    for k in range(2):
        loop, lci = step.closed_loop_tick_lci(
            loop, lci, params, lci_mpc.make_stand_policy(params), walk,
            0.01 * k)
    assert cuda_build.LAUNCHES == {"ci_sweeps": 2}
    assert bool(torch.isfinite(loop.sim.pos).all())
