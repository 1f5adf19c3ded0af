"""The batched closed-loop tick (`legged_mpc_control_tpu/control/step.py`).

One MPC tick of every scenario: the reference's three threads (main.cpp:
110-256) as one function of the batched state,

    tick = [ feedback ; MPC ; 8 x (low level -> safety -> sim step ->
             sensors -> feedback) ]

with 8 = MPC_UPDATE_FREQUENCY / LOW_LEVEL_CTRL_FREQUENCY (LeggedParams.h:7-8).
The MPC solve is kernel K1 on CUDA tensors; the fused substep chain is
kernel K2 on CUDA tensors (`ops/substep_kernel.py`). CPU tensors run the
plain versions of both. Only kf_type 0 (ground-truth feedback) and
low_level_type 0 (J^T tau control) on flat ground are ported so far.
"""

from dataclasses import dataclass

import torch

from legged_mpc_control_tpu_torch import constants as C
from legged_mpc_control_tpu_torch.config import RobotParams, param_base_ndims
from legged_mpc_control_tpu_torch.control import (
    low_level,
    raibert,
    safety,
    sensors,
)
from legged_mpc_control_tpu_torch.models import kinematics as kin
from legged_mpc_control_tpu_torch.mpc import convex_mpc, gait as gait_mod
from legged_mpc_control_tpu_torch.ops import filters, la3, so3
from legged_mpc_control_tpu_torch.ops import substep_kernel
from legged_mpc_control_tpu_torch.sim import srb_sim
from legged_mpc_control_tpu_torch.tree import Struct
from legged_mpc_control_tpu_torch.types import (
    ControllerState,
    EkfState,
    KfState,
    init_ctrl,
    init_feedback,
    init_joy,
)

EKF_STATE_SIZE = 25


@dataclass
class LoopState(Struct):
    """Carry of the closed-loop rollout: controller + simulated world."""
    controller: ControllerState
    sim: srb_sim.SimState


def controller_init(params: RobotParams, batch: int, dtype=torch.float32,
                    device=None, body_height=0.3) -> ControllerState:
    window = int(1000.0 * C.MPC_DT * 0.3)   # reference: ConvexMpc.cpp:19-20
    pattern = gait_mod.trot_pattern(dtype, device)

    def eye(n, scale):
        return (torch.eye(n, dtype=dtype, device=device) * scale).expand(
            batch, n, n).clone()

    def no():
        return torch.zeros((batch,), dtype=torch.bool, device=device)

    return ControllerState(
        fbk=init_feedback(batch, dtype, device),
        ctrl=init_ctrl(batch, dtype, device),
        joy=init_joy(batch, dtype, device, body_height),
        gait=gait_mod.gait_leg_init(pattern, batch, dtype, device),
        kf=KfState(x=torch.zeros((batch, 18), dtype=dtype, device=device),
                   P=eye(18, 3.0), initialized=no()),
        ekf=EkfState(x=torch.zeros((batch, EKF_STATE_SIZE), dtype=dtype,
                                   device=device),
                     P=eye(EKF_STATE_SIZE, 1.0), initialized=no()),
        vel_filter_x=filters.moving_window_init(window, batch, dtype, device),
        vel_filter_y=filters.moving_window_init(window, batch, dtype, device),
        estimation_inited=no(), mpc_inited=no())


def _check_kf_type(kf_type):
    if kf_type != 0:
        raise NotImplementedError(
            f"kf_type {kf_type} is not ported yet; only 0 (ground truth)")


def _feedback(fbk, ctrl, sensors_raw, params: RobotParams):
    """kf_type-0 feedback of (fbk, ctrl): sensors + Raibert footholds
    (reference: BaseInterface::fbk_update, BaseInterface.cpp:212-449, with
    the Gazebo ground-truth bypass, GazeboInterface.cpp:124-141)."""
    fbk = fbk.replace(
        root_quat=sensors_raw["quat"], imu_acc=sensors_raw["imu_acc"],
        imu_ang_vel=sensors_raw["imu_ang_vel"],
        joint_pos=sensors_raw["joint_pos"],
        joint_vel=sensors_raw["joint_vel"],
        foot_force_sensor=sensors_raw["foot_force_sensor"],
        joint_tau_est=sensors_raw.get("joint_tau_est", fbk.joint_tau_est),
        root_pos=sensors_raw["pos"], root_lin_vel=sensors_raw["vel"])
    fbk = sensors.sensor_update(fbk, params,
                                joint_ang_tgt=ctrl.joint_ang_tgt,
                                joint_vel_tgt=ctrl.joint_vel_tgt)
    target_abs, target_world = raibert.raibert_footholds(
        fbk.root_pos, fbk.root_lin_vel, fbk.root_rot_mat_z,
        ctrl.root_lin_vel_d_rel, params)
    return fbk, ctrl.replace(foot_pos_target_abs=target_abs,
                             foot_pos_target_world=target_world)


def feedback_update(cs: ControllerState, sensors_raw, params: RobotParams,
                    dt, kf_type: int = 0) -> ControllerState:
    """Feedback-thread body: raw sensors -> Feedback + Raibert targets.
    kf_type 0 (ground truth) only; the filters come in a later slice."""
    _check_kf_type(kf_type)
    fbk, ctrl = _feedback(cs.fbk, cs.ctrl, sensors_raw, params)
    return cs.replace(fbk=fbk, ctrl=ctrl,
                      estimation_inited=torch.ones_like(cs.estimation_inited))


def _lowlevel(fbk, ctrl, params: RobotParams):
    """J^T tau control + swing IK + PD + safety gate on (fbk, ctrl):
    returns (ctrl with the joint targets, tau (B,12), safe (B,))."""
    q_tgt, dq_tgt, tau_ff = low_level.tau_ctrl_update(
        fbk, ctrl.optimized_state, ctrl.optimized_input, ctrl.movement_mode,
        params)
    ctrl = ctrl.replace(joint_ang_tgt=q_tgt, joint_vel_tgt=dq_tgt,
                        joint_tau_tgt=tau_ff)
    tau = low_level.pd_torque(fbk.joint_pos, fbk.joint_vel, q_tgt, dq_tgt,
                              tau_ff, params)
    safe = safety.is_safe(fbk.root_euler, fbk.joint_vel)
    return ctrl, safety.gate_torques(tau, safe), safe


def lowlevel_update(cs: ControllerState, params: RobotParams,
                    low_level_type: int = 0):
    """Control-thread body (reference: GazeboInterface.cpp:63-88):
    returns (cs', tau (B,12), safe (B,)). low_level_type 0 only."""
    if low_level_type != 0:
        raise NotImplementedError(
            f"low_level_type {low_level_type} is not ported yet")
    ctrl, tau, safe = _lowlevel(cs.fbk, cs.ctrl, params)
    return cs.replace(ctrl=ctrl), tau, safe


def _sim_sensors(sim: srb_sim.SimState, params: RobotParams, grf_est):
    raw = srb_sim.read_sensors(sim, params)
    raw["foot_force_sensor"] = grf_est
    return raw


def _anchored_normal_force(joint_tau_tgt, sim: srb_sim.SimState,
                           params: RobotParams):
    """Foot-sensor model: the normal force each anchored leg transmits under
    the controller's last torques `joint_tau_tgt` (B,12), zero off contact:
    (B,4). (The JAX version takes the whole LoopState.)"""
    B = sim.q.shape[0]
    jac = kin.jac_legs(sim.q.reshape(B, 4, 3), params.rho_fix)
    f_rel = la3.solve3_t(jac, -joint_tau_tgt.reshape(B, 4, 3))
    R = so3.quat_to_rotmat(sim.quat)
    fz = (R[:, None] @ f_rel[..., None])[..., 2, 0]
    fz = torch.clamp(fz, min=0.0)
    return torch.where(sim.contact, fz, torch.zeros_like(fz))


def broadcast_params(params: RobotParams, batch: int) -> RobotParams:
    """Give every leaf a leading scenario axis. Leaves already batched pass
    through; shared leaves are expanded (no copy). Batched-ness is decided
    by the canonical rank, so rho_fix (4,5) is not taken for a batch of 4."""
    nd = param_base_ndims()

    def bc(name, x):
        if x.dim() == nd[name] + 1:
            return x
        return x.expand((batch,) + tuple(x.shape))
    return RobotParams(**{name: bc(name, getattr(params, name))
                          for name in nd})


def unpack_fused_feedback(cs: ControllerState, sim: srb_sim.SimState, out,
                          params: RobotParams,
                          kf_type: int = 0) -> ControllerState:
    """Rebuild the Feedback and the Raibert targets from the substep
    chain's `fb` block (FB_ROWS layout): the batched equivalent of
    `feedback_update` on the chain's final state."""
    _check_kf_type(kf_type)
    fb = out["fb"]
    B = fb.shape[0]

    def take(name, *shape):
        off, n = substep_kernel.FB_ROWS[name]
        return fb[:, off:off + n].reshape((B,) + shape if shape else (B, n))

    euler = take("euler")
    fp_abs = take("foot_pos_abs", 4, 3)
    raib_abs = take("raibert_abs", 4, 3)
    root_pos, root_vel = out["pos"], out["vel"]
    fbk = cs.fbk.replace(
        root_quat=out["quat"], root_pos=root_pos, root_lin_vel=root_vel,
        root_euler=euler, root_rot_mat=take("rotmat", 3, 3),
        root_rot_mat_z=so3.rot_z(euler[:, 2]), root_ang_vel=out["omega"],
        imu_acc=take("imu_acc"), imu_ang_vel=take("imu_gyro"),
        joint_pos=out["q"], joint_vel=out["dq"],
        foot_force_sensor=take("foot_force_sensor"),
        foot_contact_flag=take("contact_sig"),
        foot_contact_bool=take("contact_bool") > 0.5,
        foot_pos_rel=take("foot_pos_rel", 4, 3),
        foot_vel_rel=take("foot_vel_rel", 4, 3),
        jac_foot=take("jac", 4, 3, 3),
        foot_pos_abs=fp_abs, foot_vel_abs=take("foot_vel_abs", 4, 3),
        foot_pos_world=fp_abs + root_pos[:, None],
        foot_vel_world=take("foot_vel_world", 4, 3),
        foot_force_tau_est=take("force_tau_est", 4, 3))
    ctrl = cs.ctrl.replace(
        joint_ang_tgt=out["q_tgt"], joint_vel_tgt=out["dq_tgt"],
        joint_tau_tgt=out["tau_ff"], foot_pos_target_abs=raib_abs,
        foot_pos_target_world=raib_abs + root_pos[:, None])
    return cs.replace(fbk=fbk, ctrl=ctrl,
                      estimation_inited=torch.ones_like(cs.estimation_inited))


def seed_batched_feedback(loop: LoopState, params: RobotParams, *,
                          kf_type: int = 0,
                          substeps: int = C.SUBSTEPS_PER_MPC_TICK
                          ) -> LoopState:
    """One feedback pass from the raw sim sensors: seeds the carry of a
    `carry_feedback` rollout, after which the substep chain's `fb` block
    keeps the Feedback current."""
    dt_ll = C.MPC_DT / substeps
    cs = loop.controller
    grf_n = _anchored_normal_force(cs.ctrl.joint_tau_tgt, loop.sim, params)
    cs = feedback_update(cs, _sim_sensors(loop.sim, params, grf_n), params,
                         dt_ll, kf_type=kf_type)
    return loop.replace(controller=cs)


def closed_loop_tick_batched(loop: LoopState, params: RobotParams,
                             pattern: gait_mod.GaitPattern, *,
                             horizon: int = 10,
                             substeps: int = C.SUBSTEPS_PER_MPC_TICK,
                             kf_type: int = 0, iters: int = 15,
                             solver: str = "riccati",
                             low_level_type: int = 0, warm=None,
                             fused_substeps: bool = True,
                             carry_feedback: bool = False):
    """One scenario-batched closed-loop tick.

    loop: LoopState with a leading scenario axis on every leaf; params:
    RobotParams batched on every leaf (`broadcast_params`); warm: the
    previous tick's (B, 12H) solution or None.

    fused_substeps: run the 8 substeps as one substep chain (kernel K2 on
    CUDA, its plain version on CPU); False runs the per-substep loop of the
    ported modules. carry_feedback (fused only): the previous tick's chain
    already left a complete Feedback, so the opening feedback pass is
    skipped (seed the first tick with `seed_batched_feedback`).

    Returns (loop', warm')."""
    _check_kf_type(kf_type)
    if low_level_type != 0:
        raise NotImplementedError(
            f"low_level_type {low_level_type} is not ported yet")
    dt_mpc = C.MPC_DT
    dt_ll = dt_mpc / substeps
    cs = loop.controller
    if not (carry_feedback and fused_substeps):
        grf_n = _anchored_normal_force(cs.ctrl.joint_tau_tgt, loop.sim,
                                       params)
        cs = feedback_update(cs, _sim_sensors(loop.sim, params, grf_n),
                             params, dt_ll, kf_type=kf_type)
    cs, warm = convex_mpc.mpc_tick_batched(
        cs, params, pattern, dt_mpc, horizon=horizon, iters=iters,
        solver=solver, warm=warm)

    if fused_substeps:
        sim = loop.sim
        out = substep_kernel.substep_chain_cuda(
            sim.pos, sim.quat, sim.vel, sim.omega, sim.q, sim.dq,
            sim.contact, sim.anchor, cs.ctrl.optimized_state,
            cs.ctrl.optimized_input, cs.ctrl.movement_mode, params.mass,
            params.mu, params.kp_foot, params.kd_foot, params.trunk_inertia,
            params.rho_fix, params.default_foot_pos,
            params.gait_counter_speed, sensors.contact_threshold(params),
            cs.ctrl.root_lin_vel_d_rel, substeps=substeps, dt=dt_ll)
        sim = srb_sim.SimState(
            pos=out["pos"], quat=out["quat"], vel=out["vel"],
            omega=out["omega"], q=out["q"], dq=out["dq"],
            contact=out["contact"], anchor=out["anchor"],
            last_acc=out["last_acc"])
        if carry_feedback:
            cs = unpack_fused_feedback(cs, sim, out, params)
        else:
            cs = cs.replace(ctrl=cs.ctrl.replace(
                joint_ang_tgt=out["q_tgt"], joint_vel_tgt=out["dq_tgt"],
                joint_tau_tgt=out["tau_ff"]))
        return LoopState(controller=cs, sim=sim), warm

    sim = loop.sim
    for _ in range(substeps):
        cs, tau, _safe = lowlevel_update(cs, params)
        sim = srb_sim.sim_step(sim, tau, params, dt_ll)
        grf_n = _anchored_normal_force(cs.ctrl.joint_tau_tgt, sim, params)
        cs = feedback_update(cs, _sim_sensors(sim, params, grf_n), params,
                             dt_ll)
    return LoopState(controller=cs, sim=sim), warm
