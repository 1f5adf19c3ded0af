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
from legged_mpc_control_tpu_torch.ops import riccati_kernel, substep_kernel
from legged_mpc_control_tpu_torch.parallel import runner

pytestmark = pytest.mark.cuda

B = 257                  # not a multiple of the block width: bounds checks
F32 = torch.float32


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def trotting(dev):
    """A Go1 batch after 20 standing and 10 trotting ticks on the card."""
    params = go1_params(F32, dev)
    pattern = gait.trot_pattern(F32, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    loop = runner.init_loop_batch(params, B, gen, dtype=F32,
                                  body_height=0.28, device=dev)
    loop, _ = runner.make_batched_rollout(
        pattern, n_ticks=30, pdip_iters=4, walk_velx=0.15,
        stand_ticks=20)(loop, params)
    return loop, step.broadcast_params(params, B), pattern


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_riccati_kernel_matches_plain(trotting, start):
    loop, params, pattern = trotting
    _, stage = convex_mpc.mpc_prepare(loop.controller, params, pattern,
                                      0.01, horizon=10)
    args = (stage.x0, stage.x_ref, stage.A_seq, stage.B, stage.contact,
            stage.q_weights, stage.r_weights, stage.mu, stage.fz_max, 0.01)
    warm_u = None
    if start == "warm":
        warm_u = riccati.warm_shift(
            riccati.solve_qp_riccati_batched(*args, iters=15)[0],
            stage.contact)
    before = riccati_kernel.solve_qp_riccati_cuda.launches
    uk, gk, lk = riccati_kernel.solve_qp_riccati_cuda(*args, iters=15,
                                                      warm_u=warm_u)
    assert riccati_kernel.solve_qp_riccati_cuda.launches == before + 1
    up, gp, lp = riccati.solve_qp_riccati_batched(*args, iters=15,
                                                  warm_u=warm_u)
    u64 = riccati.solve_qp_riccati_batched(
        *(a.double() if torch.is_tensor(a) else a for a in args), iters=15,
        warm_u=None if warm_u is None else warm_u.double())[0]
    assert bool(torch.isfinite(uk).all()) and bool((gk < 1e-4).all())
    # the float32 bracket of chip_smoke.py: 99 % within 2e-2 N of the
    # plain version, and no farther from float64 than the plain version
    d = (uk - up).abs().amax(-1)
    assert float(torch.quantile(d.double(), 0.99)) <= 2e-2
    e64 = float((uk.double() - u64).abs().max())
    p64 = float((up.double() - u64).abs().max())
    assert e64 <= 1.5 * p64 + 2e-2
    assert lk.shape == lp.shape == (B, 10, 4, 6)


def test_riccati_kernel_refuses_float64(dev):
    x = torch.zeros((2, 10, 12), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        riccati_kernel.solve_qp_riccati_cuda(
            x[:, 0], x, x[..., None].expand(2, 10, 12, 12), x[:, :, None],
            x[..., :4], x[0, 0], x[0, 0], 0.3, 180.0, 0.01)


def test_substep_kernel_matches_plain(trotting):
    loop, params, pattern = trotting
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
    riccati_kernel.solve_qp_riccati_cuda.launches = 0
    substep_kernel.substep_chain_cuda.launches = 0
    final, (pos, _) = runner.make_batched_rollout(
        pattern, n_ticks=3, pdip_iters=4, walk_velx=0.15)(
        loop, go1_params(F32, loop.sim.pos.device))
    assert riccati_kernel.solve_qp_riccati_cuda.launches == 3
    assert substep_kernel.substep_chain_cuda.launches == 3
    assert bool(torch.isfinite(pos).all())
    assert 0.2 < float(final.sim.pos[:, 2].mean()) < 0.4
