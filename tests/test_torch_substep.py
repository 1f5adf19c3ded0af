"""The plain version of kernel K2 (`ops/substep_kernel.substep_chain_plain`)
vs the JAX package: against the XLA substep loop in f64, against the Pallas
substep kernel in interpret mode in f32, and its `fb` block unpacked against
`feedback_update` — from a mid-trot batch with mixed stance and swing legs,
built as tests/test_substep_fused.py builds it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu import constants as C
from legged_mpc_control_tpu.config import go1_params
from legged_mpc_control_tpu.control import step as jstep
from legged_mpc_control_tpu.mpc import gait
from legged_mpc_control_tpu.ops import substep_pallas
from legged_mpc_control_tpu.parallel import runner
from legged_mpc_control_tpu.sim import srb_sim
from legged_mpc_control_tpu_torch.config import params_from_numpy
from legged_mpc_control_tpu_torch.control import step as tstep
from legged_mpc_control_tpu_torch.ops import substep_kernel
from legged_mpc_control_tpu_torch.sim import srb_sim as tsim
from legged_mpc_control_tpu_torch.types import loop_state_from_numpy
from torch_parity import close, close_tree, np_tree, params_mapping

B = 8
DT_LL = C.MPC_DT / C.SUBSTEPS_PER_MPC_TICK


@pytest.fixture(scope="module")
def mid_walk():
    """f64 batch mid-trot: 3 standing + 3 walking ticks on the XLA path."""
    dt = jnp.float64
    params1 = go1_params(dt)
    pattern = gait.trot_pattern(dt)
    loop = runner.init_loop_batch(params1, B, jax.random.PRNGKey(3),
                                  dtype=dt)
    params = jax.jit(jstep.broadcast_params, static_argnums=1)(params1, B)
    warm = jnp.zeros((B, 120), dt)
    for i in range(6):
        cs = loop.controller
        mode = jnp.full((B,), int(i >= 3), jnp.int32)
        cs = cs.replace(ctrl=cs.ctrl.replace(movement_mode=mode),
                        joy=cs.joy.replace(velx=jnp.full((B,), 0.25, dt)))
        loop, warm = jstep.closed_loop_tick_batched(
            loop.replace(controller=cs), params, pattern, horizon=10,
            iters=10, solver="riccati", backend="xla", warm=warm,
            fused_substeps=False)
    contact = np.asarray(loop.sim.contact)
    assert contact.any() and not contact.all(), "want mixed contacts"
    return loop, params


@jax.jit
def _xla_substeps(loop, params):
    """The XLA substep loop of closed_loop_tick_batched (two substeps),
    replicated as tests/test_substep_fused.py does."""
    cs = loop.controller
    v_anf = jax.vmap(jstep._anchored_normal_force)
    v_sensors = jax.vmap(jstep._sim_sensors)
    v_fb = jax.vmap(lambda c, raw, pp: jstep.feedback_update(
        c, raw, pp, DT_LL, kf_type=0))
    v_ll = jax.vmap(lambda c, pp: jstep.lowlevel_update(c, pp, 0))
    v_sim = jax.vmap(lambda ss, tt, pp: srb_sim.sim_step(ss, tt, pp, DT_LL))
    sim = loop.sim
    for _ in range(2):
        cs, tau, _safe = v_ll(cs, params)
        sim = v_sim(sim, tau, params)
        grf_n = jnp.where(sim.contact, v_anf(
            jstep.LoopState(controller=cs, sim=sim), params), 0.0)
        cs = v_fb(cs, v_sensors(sim, params, grf_n), params)
    return sim, cs


def _chain_args(loop, params):
    """The substep chain's arguments from a loop state (JAX or port)."""
    cs, sim = loop.controller, loop.sim
    thresh = (params.foot_sensor_min + params.foot_sensor_ratio
              * (params.foot_sensor_max - params.foot_sensor_min))
    return (sim.pos, sim.quat, sim.vel, sim.omega, sim.q, sim.dq,
            sim.contact, sim.anchor, cs.ctrl.optimized_state,
            cs.ctrl.optimized_input, cs.ctrl.movement_mode, params.mass,
            params.mu, params.kp_foot, params.kd_foot, params.trunk_inertia,
            params.rho_fix, params.default_foot_pos,
            params.gait_counter_speed, thresh, cs.ctrl.root_lin_vel_d_rel)


@pytest.fixture(scope="module")
def case64(mid_walk):
    loop, params = mid_walk
    sim_ref, cs_ref = np_tree(_xla_substeps(loop, params))
    tloop = loop_state_from_numpy(np_tree(loop))
    tparams = params_from_numpy(params_mapping(params))
    out = substep_kernel.substep_chain_plain(
        *_chain_args(tloop, tparams), substeps=2, dt=DT_LL)
    return tloop, tparams, out, sim_ref, cs_ref


@pytest.mark.parametrize("field", ["pos", "quat", "vel", "omega", "q", "dq",
                                   "anchor", "last_acc"])
def test_plain_state_matches_jax_xla_f64(case64, field):
    _, _, out, sim_ref, _ = case64
    close(out[field], getattr(sim_ref, field), 1e-8, what=field)


def test_plain_contacts_and_targets_match_jax_xla_f64(case64):
    _, _, out, sim_ref, cs_ref = case64
    assert np.array_equal(out["contact"].numpy(), sim_ref.contact)
    close(out["q_tgt"], cs_ref.ctrl.joint_ang_tgt, 1e-8, what="q_tgt")
    close(out["dq_tgt"], cs_ref.ctrl.joint_vel_tgt, 1e-8, what="dq_tgt")
    close(out["tau_ff"], cs_ref.ctrl.joint_tau_tgt, 1e-8, what="tau_ff")


def test_fb_block_unpacks_to_feedback_update(case64):
    """unpack_fused_feedback of the plain fb block == the XLA loop's own
    feedback_update of the same final state (f64, same arithmetic)."""
    tloop, tparams, out, _, cs_ref = case64
    sim = tsim.SimState(**{k: out[k] for k in (
        "pos", "quat", "vel", "omega", "q", "dq", "contact", "anchor",
        "last_acc")})
    got = tstep.unpack_fused_feedback(tloop.controller, sim, out, tparams)
    close_tree(got.fbk, cs_ref.fbk, 1e-8, what="fbk")
    close(got.ctrl.foot_pos_target_world, cs_ref.ctrl.foot_pos_target_world,
          1e-8)
    close(got.ctrl.foot_pos_target_abs, cs_ref.ctrl.foot_pos_target_abs,
          1e-8)


def test_plain_f32_matches_pallas_interpret(mid_walk):
    """f32 plain chain vs the Pallas kernel in interpret mode, two
    substeps, with the tolerances of tests/test_substep_fused.py."""
    loop64, params64 = mid_walk

    def f32(x):                      # cast in numpy: no XLA compilations
        return x.astype(np.float32) if x.dtype == np.float64 else x
    loop = jax.tree.map(f32, np_tree(loop64))
    params = jax.tree.map(f32, np_tree(params64))
    want = np_tree(substep_pallas.substep_chain_fused(
        *_chain_args(loop, params), substeps=2, dt=DT_LL,
        interpret=True))
    tloop = loop_state_from_numpy(loop)
    tparams = params_from_numpy(params_mapping(params))
    assert tloop.sim.pos.dtype == torch.float32
    got = substep_kernel.substep_chain_plain(
        *_chain_args(tloop, tparams), substeps=2, dt=DT_LL)
    for name, tol in (("pos", 2e-4), ("quat", 2e-4), ("vel", 2e-3),
                      ("omega", 5e-3), ("q", 2e-3), ("dq", 5e-2),
                      ("anchor", 2e-4), ("q_tgt", 2e-3), ("dq_tgt", 5e-2),
                      ("tau_ff", 1e-2)):
        close(got[name], want[name], tol, what=name)
    assert np.array_equal(got["contact"].numpy(), want["contact"])


def test_wrapper_on_cpu_runs_plain_without_launch(case64):
    tloop, tparams, out, _, _ = case64
    before = substep_kernel.substep_chain_cuda.launches
    again = substep_kernel.substep_chain_cuda(
        *_chain_args(tloop, tparams), substeps=2, dt=DT_LL)
    assert substep_kernel.substep_chain_cuda.launches == before
    for k, v in out.items():
        assert torch.equal(again[k], v), k
