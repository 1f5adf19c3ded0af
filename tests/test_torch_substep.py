"""The plain versions of kernels K2 and K3 (`ops/substep_kernel.
substep_chain_plain`, kf_type 0 and 1) vs the JAX package: against the XLA
substep loop in f64, against the Pallas substep kernel in interpret mode in
f32 (two substeps: every substep is the same program, two cover the carry,
as tests/test_substep_fused.py checks the TPU kernel), and K2's `fb` block
unpacked against `feedback_update`.

The start is a Go1 batch mid-trot with mixed stance and swing legs (and
under kf_type 1 a settled filter), built by the port's own unfused rollout
in float64 on the CPU and carried into the JAX package, so both sides start
from the same numbers."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu import constants as C
from legged_mpc_control_tpu.config import go1_params
from legged_mpc_control_tpu.control import step as jstep
from legged_mpc_control_tpu.ops import substep_pallas
from legged_mpc_control_tpu.parallel import runner
from legged_mpc_control_tpu.sim import srb_sim
from legged_mpc_control_tpu_torch.config import go1_params as tgo1
from legged_mpc_control_tpu_torch.config import params_from_numpy
from legged_mpc_control_tpu_torch.control import step as tstep
from legged_mpc_control_tpu_torch.mpc import gait as tgait
from legged_mpc_control_tpu_torch.ops import cuda_build, substep_kernel
from legged_mpc_control_tpu_torch.parallel import runner as trunner
from legged_mpc_control_tpu_torch.sim import srb_sim as tsim
from legged_mpc_control_tpu_torch.types import (
    loop_state_from_numpy,
    loop_state_to_numpy,
)
from torch_parity import (
    close,
    close_tree,
    jax_tree_from,
    np_tree,
    params_mapping,
)

B = 8
DT_LL = C.MPC_DT / C.SUBSTEPS_PER_MPC_TICK
SUBSTEPS = 2
CPU = torch.device("cpu")


def _mid_walk(kf_type, seed):
    """f64 batch after 3 standing and 4 trotting ticks of the port's
    unfused loop at 0.25 m/s, as a JAX LoopState, and the broadcast JAX
    RobotParams."""
    f64 = torch.float64
    tparams = tgo1(f64, CPU)
    loop = trunner.init_loop_batch(tparams, B,
                                   torch.Generator().manual_seed(seed),
                                   dtype=f64, body_height=0.28, device=CPU)
    loop, _ = trunner.make_batched_rollout(
        tgait.trot_pattern(f64, CPU), n_ticks=7, pdip_iters=10,
        walk_velx=0.25, stand_ticks=3, kf_type=kf_type,
        fused_substeps=False)(loop, tparams)
    contact = loop.sim.contact.numpy()
    assert contact.any() and not contact.all(), "want mixed contacts"
    params1 = go1_params(jnp.float64)
    template = runner.init_loop_batch(params1, B, jax.random.PRNGKey(0),
                                      dtype=jnp.float64)
    params = jax.jit(jstep.broadcast_params, static_argnums=1)(params1, B)
    return jax_tree_from(template, loop_state_to_numpy(loop)), params


@pytest.fixture(scope="module")
def mid_walk():
    return _mid_walk(0, 3)


@pytest.fixture(scope="module")
def mid_walk_kf1():
    loop, params = _mid_walk(1, 5)
    assert bool(np.all(np.asarray(loop.controller.kf.initialized)))
    return loop, params


@functools.partial(jax.jit, static_argnames="kf_type")
def _xla_substeps(loop, params, kf_type):
    """The XLA substep loop of closed_loop_tick_batched (two substeps),
    replicated as tests/test_substep_fused.py does."""
    cs = loop.controller
    v_anf = jax.vmap(jstep._anchored_normal_force)
    v_sensors = jax.vmap(jstep._sim_sensors)
    v_fb = jax.vmap(lambda c, raw, pp: jstep.feedback_update(
        c, raw, pp, DT_LL, kf_type=kf_type))
    v_ll = jax.vmap(lambda c, pp: jstep.lowlevel_update(c, pp, 0))
    v_sim = jax.vmap(lambda ss, tt, pp: srb_sim.sim_step(ss, tt, pp, DT_LL))
    sim = loop.sim
    for _ in range(SUBSTEPS):
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


def _plain(loop, params, kf_type):
    kf = dict(kf_x=loop.controller.kf.x, kf_P=loop.controller.kf.P) \
        if kf_type == 1 else {}
    return substep_kernel.substep_chain_plain(
        *_chain_args(loop, params), substeps=SUBSTEPS, dt=DT_LL,
        kf_type=kf_type, **kf)


def _case64(mid, kf_type):
    loop, params = mid
    sim_ref, cs_ref = np_tree(_xla_substeps(loop, params, kf_type=kf_type))
    tloop = loop_state_from_numpy(np_tree(loop))
    tparams = params_from_numpy(params_mapping(params))
    return tloop, tparams, _plain(tloop, tparams, kf_type), sim_ref, cs_ref


def _case32(mid, kf_type):
    """The f32 plain chain and the Pallas kernel in interpret mode."""
    loop64, params64 = mid

    def f32(x):                      # cast in numpy: no XLA compilations
        return x.astype(np.float32) if x.dtype == np.float64 else x
    loop = jax.tree.map(f32, np_tree(loop64))
    params = jax.tree.map(f32, np_tree(params64))
    kf = dict(kf_x=loop.controller.kf.x, kf_P=loop.controller.kf.P) \
        if kf_type == 1 else {}
    want = np_tree(substep_pallas.substep_chain_fused(
        *_chain_args(loop, params), substeps=SUBSTEPS, dt=DT_LL,
        kf_type=kf_type, interpret=True, **kf))
    tloop = loop_state_from_numpy(loop)
    assert tloop.sim.pos.dtype == torch.float32
    got = _plain(tloop, params_from_numpy(params_mapping(params)), kf_type)
    return got, want


@pytest.fixture(scope="module")
def case64(mid_walk):
    return _case64(mid_walk, 0)


@pytest.fixture(scope="module")
def case64_kf1(mid_walk_kf1):
    return _case64(mid_walk_kf1, 1)


@pytest.fixture(scope="module")
def case32_kf1(mid_walk_kf1):
    return _case32(mid_walk_kf1, 1)


# --- K2 (kf_type 0) ---------------------------------------------------------

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
    got, want = _case32(mid_walk, 0)
    for name, tol in (("pos", 2e-4), ("quat", 2e-4), ("vel", 2e-3),
                      ("omega", 5e-3), ("q", 2e-3), ("dq", 5e-2),
                      ("anchor", 2e-4), ("q_tgt", 2e-3), ("dq_tgt", 5e-2),
                      ("tau_ff", 1e-2)):
        close(got[name], want[name], tol, what=name)
    assert np.array_equal(got["contact"].numpy(), want["contact"])


def test_wrapper_on_cpu_runs_plain_without_launch(case64):
    tloop, tparams, out, _, _ = case64
    before = dict(cuda_build.LAUNCHES)
    again = substep_kernel.substep_chain_cuda(
        *_chain_args(tloop, tparams), substeps=SUBSTEPS, dt=DT_LL)
    assert cuda_build.LAUNCHES == before
    for k, v in out.items():
        assert torch.equal(again[k], v), k


# --- K3 (kf_type 1, the 18-state KF in every substep) -----------------------

@pytest.mark.parametrize("field", ["pos", "quat", "vel", "omega", "q", "dq",
                                   "anchor", "last_acc"])
def test_plain_kf1_state_matches_jax_xla_f64(case64_kf1, field):
    _, _, out, sim_ref, _ = case64_kf1
    close(out[field], getattr(sim_ref, field), 1e-8, what=field)


def test_plain_kf1_filter_and_targets_match_jax_xla_f64(case64_kf1):
    """The filter state, the estimate the controller reads, and the joint
    and foothold targets computed from it: the same float64 arithmetic."""
    _, _, out, sim_ref, cs_ref = case64_kf1
    assert np.array_equal(out["contact"].numpy(), sim_ref.contact)
    close(out["kf_x"], cs_ref.kf.x, 1e-8, what="kf_x")
    close(out["kf_P"], cs_ref.kf.P, 1e-8, what="kf_P")
    for name, want in (("q_tgt", cs_ref.ctrl.joint_ang_tgt),
                       ("dq_tgt", cs_ref.ctrl.joint_vel_tgt),
                       ("tau_ff", cs_ref.ctrl.joint_tau_tgt)):
        close(out[name], want, 1e-8, what=name)
    off, n = substep_kernel.FB_ROWS["raibert_abs"]
    close(out["fb"][:, off:off + n],
          cs_ref.ctrl.foot_pos_target_abs.reshape(B, 12), 1e-8,
          what="raibert_abs")
    # the filter is not the truth: the check above is not vacuous
    assert float(np.abs(cs_ref.kf.x[:, 0:3] - sim_ref.pos).max()) > 1e-6


# The one-call tolerances of tests/test_substep_fused.py's kf1 test (float32
# orderings of the same chain, the Pallas kernel's polynomial atan and its
# KF input `acc` = R a_imu + g up to rounding), and for the fb block those
# of chip_smoke.py's FB_TOL.
STATE_TOL = {"pos": 2e-4, "quat": 2e-4, "vel": 2e-3, "omega": 5e-3,
             "q": 2e-3, "dq": 5e-2, "anchor": 2e-4, "q_tgt": 2e-3,
             "dq_tgt": 5e-2, "tau_ff": 1e-2, "kf_x": 2e-3}
FB_TOL = {"euler": 1e-4, "rotmat": 1e-4, "foot_pos_rel": 2e-3,
          "foot_pos_abs": 2e-3, "foot_vel_rel": 6e-2, "foot_vel_abs": 6e-2,
          "foot_vel_world": 6e-2, "jac": 2e-3, "foot_force_sensor": 0.5,
          "contact_sig": 0.05, "contact_bool": 0.0, "force_tau_est": 0.5,
          "raibert_abs": 2e-3, "imu_acc": 5e-2, "imu_gyro": 5e-3}


@pytest.mark.parametrize("field", sorted(STATE_TOL))
def test_plain_kf1_f32_matches_pallas_interpret(case32_kf1, field):
    got, want = case32_kf1
    close(got[field], want[field], STATE_TOL[field], what=field)


def test_plain_kf1_f32_covariance_and_fb_match_pallas_interpret(case32_kf1):
    got, want = case32_kf1
    assert np.array_equal(got["contact"].numpy(), want["contact"])
    close(got["kf_P"], want["kf_P"], 2e-4, rtol=2e-3, what="kf_P")
    for name, (off, n) in substep_kernel.FB_ROWS.items():
        close(got["fb"][:, off:off + n], want["fb"][:, off:off + n],
              FB_TOL[name], what=f"fb {name}")
