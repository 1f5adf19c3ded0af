"""The whole slice: the port's `make_batched_rollout` on the CPU (plain
versions of the kernels) vs the JAX `runner.make_batched_rollout` (XLA
backend, unfused substeps), from the same JAX `init_loop_batch` state: the
Riccati loop with kf_type 0, then (riccati, kf_type 1), (pdip, kf_type 0)
and (admm, kf_type 0).

f64, Go1, trot, H=10, 3 standing + 3 walking ticks at 0.25 m/s. Over so
few ticks the same float64 arithmetic does not diverge (the contact chaos
the bench's distributional gates allow for sets in later), so positions and
velocities must agree to 1e-6 at every tick. Each JAX rollout is compiled
once (XLA:CPU's compile count, pytest.ini)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu.config import go1_params as jgo1
from legged_mpc_control_tpu.mpc import gait as jgait
from legged_mpc_control_tpu.parallel import runner as jrunner
from legged_mpc_control_tpu_torch.config import go1_params
from legged_mpc_control_tpu_torch.control import step as tstep
from legged_mpc_control_tpu_torch.mpc import convex_mpc as tmpc
from legged_mpc_control_tpu_torch.mpc import gait as tgait
from legged_mpc_control_tpu_torch.mpc import riccati as tric
from legged_mpc_control_tpu_torch.parallel import runner as trunner
from legged_mpc_control_tpu_torch.types import loop_state_from_numpy
from torch_parity import close, np_tree

CPU = torch.device("cpu")

B = 8
H = 10
ITERS = 10
STAND, WALK = 3, 3
VELX = 0.25
SETTING = dict(horizon=H, n_ticks=STAND + WALK, pdip_iters=ITERS,
               walk_velx=VELX, stand_ticks=STAND)


@pytest.fixture(scope="module")
def jax_rollout():
    p = jgo1(jnp.float64)
    loop = jrunner.init_loop_batch(p, B, jax.random.PRNGKey(11),
                                   dtype=jnp.float64, body_height=0.28,
                                   height_range=(0.26, 0.30))
    roll = jax.jit(jrunner.make_batched_rollout(
        jgait.trot_pattern(jnp.float64), solver="riccati", backend="xla",
        fused_substeps=False, **SETTING))
    final, (pos, vel) = roll(loop, p)
    return np_tree(loop), np_tree(final), np.asarray(pos), np.asarray(vel)


@pytest.mark.parametrize("fused", [True, False])
def test_rollout_matches_jax(jax_rollout, fused):
    loop0, final, pos, vel = jax_rollout
    roll = trunner.make_batched_rollout(
        tgait.trot_pattern(torch.float64, CPU), fused_substeps=fused,
        **SETTING)
    got, (gpos, gvel) = roll(loop_state_from_numpy(loop0),
                             go1_params(torch.float64, CPU))
    assert gpos.shape == (STAND + WALK, B, 3)
    for k in range(STAND + WALK):
        close(gpos[k], pos[k], 1e-6, what=f"pos tick {k}")
        close(gvel[k], vel[k], 1e-6, what=f"vel tick {k}")
    assert np.array_equal(got.sim.contact.numpy(), final.sim.contact)
    close(got.sim.q, final.sim.q, 1e-6, what="joints")
    close(got.controller.ctrl.optimized_input,
          final.controller.ctrl.optimized_input, 1e-4, what="GRF [N]")
    # the batch trots: some legs swing, everyone moves forward
    assert not got.sim.contact.all()
    assert bool((gvel[-1, :, 0] > 0).all())


@pytest.fixture(scope="module")
def walking_state(jax_rollout):
    """The port's batch after the rollout, feedback seeded for a tick."""
    _, final, _, _ = jax_rollout
    params = tstep.broadcast_params(go1_params(torch.float64, CPU), B)
    loop = tstep.seed_batched_feedback(loop_state_from_numpy(final), params)
    return loop, params


def test_warm_start_carry(walking_state):
    """The tick returns its full (B, 12H) solution as the next warm start,
    and the next solve starts from its one-stage shift."""
    loop, params = walking_state
    pattern = tgait.trot_pattern(torch.float64, CPU)
    cs = loop.controller
    cs = cs.replace(ctrl=cs.ctrl.replace(movement_mode=torch.ones(
        B, dtype=torch.int32)))
    warm = torch.zeros((B, 12 * H), dtype=torch.float64)
    cs1, warm1 = tmpc.mpc_tick_batched(cs, params, pattern, 0.01, horizon=H,
                                       iters=ITERS, warm=warm)
    assert warm1.shape == (B, 12 * H)
    close(cs1.ctrl.optimized_input[:, :12], warm1[:, :12], 0.0)
    cs2, warm2 = tmpc.mpc_tick_batched(cs1, params, pattern, 0.01,
                                       horizon=H, iters=ITERS, warm=warm1)
    _, stage = tmpc.mpc_prepare(cs1, params, pattern, 0.01, horizon=H)
    u, _, _ = tric.solve_qp_riccati_batched(
        stage.x0, stage.x_ref, stage.A_seq, stage.B, stage.contact,
        stage.q_weights, stage.r_weights, stage.mu, stage.fz_max, 0.01,
        iters=ITERS, warm_u=tric.warm_shift(warm1, stage.contact))
    close(warm2, u, 0.0)
    # a warm start changes the answer only within the solver's accuracy
    cold = tric.solve_qp_riccati_batched(
        stage.x0, stage.x_ref, stage.A_seq, stage.B, stage.contact,
        stage.q_weights, stage.r_weights, stage.mu, stage.fz_max, 0.01,
        iters=30)[0]
    close(warm2[:, :12], cold[:, :12], 0.5, what="warm vs converged [N]")


def test_nan_guard_zeroes_one_scenario(walking_state):
    """A scenario whose solve comes back non-finite (here: a NaN warm
    start) gets zero GRFs; the others are untouched (reference:
    ConvexQPSolver.cpp:321-326)."""
    loop, params = walking_state
    pattern = tgait.trot_pattern(torch.float64, CPU)
    cs = loop.controller
    warm = torch.zeros((B, 12 * H), dtype=torch.float64)
    clean, _ = tmpc.mpc_tick_batched(cs, params, pattern, 0.01, horizon=H,
                                     iters=ITERS, warm=warm)
    warm[3] = float("nan")
    got, warm_out = tmpc.mpc_tick_batched(cs, params, pattern, 0.01,
                                          horizon=H, iters=ITERS, warm=warm)
    grf = got.ctrl.optimized_input[:, :12]
    assert bool(torch.isnan(warm_out[3]).any())
    assert bool((grf[3] == 0).all())
    keep = [i for i in range(B) if i != 3]
    close(grf[keep], clean.ctrl.optimized_input[keep, :12], 0.0)
    assert bool(torch.isfinite(got.ctrl.optimized_input).all())


# --- the closed loops of the condensed solvers and the in-loop KF --------

B4 = 4
LOOP_SETTING = dict(horizon=H, n_ticks=STAND + WALK, walk_velx=VELX,
                    stand_ticks=STAND)
# solver, kf_type, iterations per tick
CASES = {"riccati-kf1": ("riccati", 1, 10), "pdip-kf0": ("pdip", 0, 10),
         "admm-kf0": ("admm", 0, 30)}


@pytest.fixture(scope="module", params=sorted(CASES))
def jax_loop(request):
    solver, kf_type, iters = CASES[request.param]
    p = jgo1(jnp.float64)
    loop = jrunner.init_loop_batch(p, B4, jax.random.PRNGKey(13),
                                   dtype=jnp.float64, body_height=0.28,
                                   height_range=(0.26, 0.30))
    roll = jax.jit(jrunner.make_batched_rollout(
        jgait.trot_pattern(jnp.float64), solver=solver, backend="xla",
        kf_type=kf_type, pdip_iters=iters, fused_substeps=False,
        **LOOP_SETTING))
    final, (pos, vel) = roll(loop, p)
    return (request.param, np_tree(loop), np_tree(final), np.asarray(pos),
            np.asarray(vel))


def _port_rollout(case, loop0, fused):
    solver, kf_type, iters = CASES[case]
    roll = trunner.make_batched_rollout(
        tgait.trot_pattern(torch.float64, CPU), solver=solver,
        kf_type=kf_type, pdip_iters=iters, fused_substeps=fused,
        **LOOP_SETTING)
    return roll(loop_state_from_numpy(loop0), go1_params(torch.float64, CPU))


def test_solver_and_filter_rollout_matches_jax(jax_loop):
    """The unfused per-substep loop, the path the JAX XLA backend takes."""
    case, loop0, final, pos, vel = jax_loop
    got, (gpos, gvel) = _port_rollout(case, loop0, fused=False)
    for k in range(STAND + WALK):
        close(gpos[k], pos[k], 1e-6, what=f"pos tick {k}")
        close(gvel[k], vel[k], 1e-6, what=f"vel tick {k}")
    assert np.array_equal(got.sim.contact.numpy(), final.sim.contact)
    close(got.sim.q, final.sim.q, 1e-6, what="joints")
    close(got.controller.ctrl.optimized_input,
          final.controller.ctrl.optimized_input, 1e-4, what="GRF [N]")
    close(got.controller.kf.x, final.controller.kf.x, 1e-6, what="kf x")
    # the batch trots: some legs swing, everyone moves forward
    assert not got.sim.contact.all()
    assert bool((gvel[-1, :, 0] > 0).all())


def test_solver_and_filter_fused_rollout(jax_loop):
    """The fused substep chain (the plain version of K2, or K3 under
    kf_type 1) with the Feedback carried in its fb block. Under kf_type 0
    it is the same float64 arithmetic as the unfused loop. Under kf_type 1
    the fused tick has no opening feedback pass, so its filter takes 8
    steps a tick where the unfused loop takes 9 (as on the TPU); the
    trajectories then agree to the filter's effect, bounded here at 1 mm
    and 1 cm/s over the 6 ticks."""
    case, loop0, final, pos, vel = jax_loop
    got, (gpos, gvel) = _port_rollout(case, loop0, fused=True)
    kf1 = CASES[case][1] == 1
    tol_pos, tol_vel = (1e-3, 1e-2) if kf1 else (1e-6, 1e-6)
    for k in range(STAND + WALK):
        close(gpos[k], pos[k], tol_pos, what=f"pos tick {k}")
        close(gvel[k], vel[k], tol_vel, what=f"vel tick {k}")
    if kf1:
        assert bool(got.controller.kf.initialized.all())
        err = (got.controller.kf.x[:, 0:3] - got.sim.pos).abs()
        assert float(err[:, 2].max()) < 0.025
