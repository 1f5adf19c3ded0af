"""The two batched closed-loop ticks the benchmark's cells drive, in plain
PyTorch: a frozen copy of the port's `control/step.py` cut to kf_type 0,
the J^T tau low level and flat ground, with the substep chain's plain
version (`ops/substep_kernel.substep_chain_plain`, kf_type 0) in place of
kernel K2, and the batch constructors of `parallel/runner.py` and
`parallel/distributed.py`.

    convex:  [feedback carried from the last chain ; MPC prepare + Riccati
              IPM ; 8 substeps -> Feedback block]
    CI:      [feedback ; LCI seam with the CI walk policy ; 8 substeps]
"""

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import constants as C
from benchmark.reference.config import RobotParams, param_base_ndims
from benchmark.reference.control import low_level, raibert, safety, sensors
from benchmark.reference.models import kinematics as kin
from benchmark.reference.mpc import convex_mpc, gait as gait_mod, lci_mpc
from benchmark.reference.ops import filters, la3, so3
from benchmark.reference.sim import srb_sim
from benchmark.reference.tree import Struct
from benchmark.reference.types import (
    ControllerState,
    EkfState,
    KfState,
    init_ctrl,
    init_feedback,
    init_joy,
)

# the filters' state sizes (estimation/basic_kf.py, estimation/ekf.py): the
# controller state carries both filters, which kf_type 0 never steps
KF_STATE_SIZE = 18
EKF_STATE_SIZE = 25

# fb block row layout of the substep chain (ops/substep_kernel.py)
FB_ROWS = {
    "euler": (0, 3), "rotmat": (3, 9), "foot_pos_rel": (12, 12),
    "foot_pos_abs": (24, 12), "foot_vel_rel": (36, 12),
    "foot_vel_abs": (48, 12), "foot_vel_world": (60, 12),
    "jac": (72, 36), "foot_force_sensor": (108, 4),
    "contact_sig": (112, 4), "contact_bool": (116, 4),
    "force_tau_est": (120, 12), "raibert_abs": (132, 12),
    "imu_acc": (144, 3), "imu_gyro": (147, 3),
}
FB_N = 150



@dataclass
class LoopState(Struct):
    """Carry of the closed-loop rollout: controller + simulated world."""
    controller: ControllerState
    sim: srb_sim.SimState


def controller_init(params: RobotParams, batch: int, dtype=torch.float32,
                    device="cuda", body_height=0.3) -> ControllerState:
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
        gait=gait_mod.gait_leg_init(pattern, batch, dtype),
        kf=KfState(x=torch.zeros((batch, KF_STATE_SIZE), dtype=dtype,
                                 device=device),
                   P=eye(KF_STATE_SIZE, 3.0), initialized=no()),
        ekf=EkfState(x=torch.zeros((batch, EKF_STATE_SIZE), dtype=dtype,
                                   device=device),
                     P=eye(EKF_STATE_SIZE, 1.0), initialized=no()),
        vel_filter_x=filters.moving_window_init(window, batch, dtype, device),
        vel_filter_y=filters.moving_window_init(window, batch, dtype, device),
        estimation_inited=no(), mpc_inited=no())


def _sensed(fbk, ctrl, sensors_raw, params: RobotParams, ground_truth):
    """Raw sensors into the Feedback plus its derived products
    (reference: BaseInterface::sensor_update, BaseInterface.cpp:212-402).
    ground_truth: the kf_type-0 bypass takes the sim's root position and
    velocity (GazeboInterface.cpp:124-141); otherwise they stay the last
    estimate until the filter runs."""
    fbk = fbk.replace(
        root_quat=sensors_raw["quat"], imu_acc=sensors_raw["imu_acc"],
        imu_ang_vel=sensors_raw["imu_ang_vel"],
        joint_pos=sensors_raw["joint_pos"],
        joint_vel=sensors_raw["joint_vel"],
        foot_force_sensor=sensors_raw["foot_force_sensor"],
        joint_tau_est=sensors_raw.get("joint_tau_est", fbk.joint_tau_est))
    if ground_truth:
        fbk = fbk.replace(root_pos=sensors_raw["pos"],
                          root_lin_vel=sensors_raw["vel"])
    return sensors.sensor_update(fbk, params,
                                 joint_ang_tgt=ctrl.joint_ang_tgt,
                                 joint_vel_tgt=ctrl.joint_vel_tgt)


def _feedback(fbk, ctrl, sensors_raw, params: RobotParams):
    """Feedback-thread body under kf_type 0 (ground truth): sensors and the
    Raibert footholds (reference: BaseInterface::fbk_update,
    BaseInterface.cpp:212-449). Returns (fbk, ctrl)."""
    fbk = _sensed(fbk, ctrl, sensors_raw, params, ground_truth=True)
    target_abs, target_world = raibert.raibert_footholds(
        fbk.root_pos, fbk.root_lin_vel, fbk.root_rot_mat_z,
        ctrl.root_lin_vel_d_rel, params)
    return fbk, ctrl.replace(foot_pos_target_abs=target_abs,
                             foot_pos_target_world=target_world)


def feedback_update(cs: ControllerState, sensors_raw,
                    params: RobotParams) -> ControllerState:
    """Feedback-thread body: raw sensors -> Feedback + Raibert targets."""
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
                          params: RobotParams) -> ControllerState:
    """Rebuild the Feedback and the Raibert targets from the substep
    chain's `fb` block (FB_ROWS layout): the batched equivalent of
    `feedback_update` on the chain's final state."""
    fb = out["fb"]
    B = fb.shape[0]

    def take(name, *shape):
        off, n = FB_ROWS[name]
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


def seed_batched_feedback(loop: LoopState, params: RobotParams) -> LoopState:
    """One feedback pass from the raw sim sensors: seeds the carry of a
    `carry_feedback` rollout."""
    cs = loop.controller
    grf_n = _anchored_normal_force(cs.ctrl.joint_tau_tgt, loop.sim, params)
    cs = feedback_update(cs, _sim_sensors(loop.sim, params, grf_n), params)
    return loop.replace(controller=cs)


def substep_chain_plain(sim_pos, sim_quat, sim_vel, sim_omega, sim_q,
                        sim_dq, sim_contact, sim_anchor, opt_state,
                        opt_input, movement_mode, mass, mu, kp_foot,
                        kd_foot, trunk_inertia, rho_fix, default_foot_pos,
                        gait_counter_speed, contact_thresh, vel_d_rel, *,
                        substeps, dt):
    """Plain version of kernel K2: the per-substep loop (low level -> sim
    step -> sensors -> feedback), then the `fb` block of the final
    Feedback."""
    B = sim_pos.shape[0]
    dtype, dev = sim_pos.dtype, sim_pos.device
    # the fields the chain reads; the sensor threshold enters as
    # min + 0 * (max - min), exactly `contact_thresh`
    params = RobotParams(
        mass=mass, trunk_inertia=trunk_inertia, q_weights=None,
        r_weights=None, mu=mu, fz_max=None,
        gait_counter_speed=gait_counter_speed,
        default_foot_pos=default_foot_pos, kp_foot=kp_foot, kd_foot=kd_foot,
        foot_sensor_min=contact_thresh, foot_sensor_max=contact_thresh,
        foot_sensor_ratio=torch.zeros_like(contact_thresh), rho_fix=rho_fix,
        max_body_height=None, min_body_height=None)
    sim = srb_sim.SimState(
        pos=sim_pos, quat=sim_quat, vel=sim_vel, omega=sim_omega, q=sim_q,
        dq=sim_dq, contact=sim_contact, anchor=sim_anchor,
        last_acc=torch.zeros_like(sim_pos))
    ctrl = init_ctrl(B, dtype, dev).replace(
        movement_mode=movement_mode, optimized_state=opt_state,
        optimized_input=opt_input, root_lin_vel_d_rel=vel_d_rel)
    # the opening Feedback: only its kinematic products feed the first
    # substep's low level, so the foot sensor may read zero here
    fbk, ctrl = _feedback(
        init_feedback(B, dtype, dev), ctrl,
        _sim_sensors(sim, params, torch.zeros_like(sim_quat)), params)
    for _ in range(substeps):
        ctrl, tau, _safe = _lowlevel(fbk, ctrl, params)
        sim = srb_sim.sim_step(sim, tau, params, dt)
        grf_n = _anchored_normal_force(ctrl.joint_tau_tgt, sim, params)
        fbk, ctrl = _feedback(fbk, ctrl, _sim_sensors(sim, params, grf_n),
                              params)

    fb = torch.cat([
        fbk.root_euler, fbk.root_rot_mat.reshape(B, 9),
        fbk.foot_pos_rel.reshape(B, 12), fbk.foot_pos_abs.reshape(B, 12),
        fbk.foot_vel_rel.reshape(B, 12), fbk.foot_vel_abs.reshape(B, 12),
        fbk.foot_vel_world.reshape(B, 12), fbk.jac_foot.reshape(B, 36),
        fbk.foot_force_sensor, fbk.foot_contact_flag,
        fbk.foot_contact_bool.to(dtype),
        fbk.foot_force_tau_est.reshape(B, 12),
        ctrl.foot_pos_target_abs.reshape(B, 12), fbk.imu_acc,
        fbk.imu_ang_vel], dim=-1)
    return dict(pos=sim.pos, quat=sim.quat, vel=sim.vel, omega=sim.omega,
                q=sim.q, dq=sim.dq, contact=sim.contact, anchor=sim.anchor,
                last_acc=sim.last_acc, q_tgt=ctrl.joint_ang_tgt,
                dq_tgt=ctrl.joint_vel_tgt, tau_ff=ctrl.joint_tau_tgt, fb=fb)


def _substep_chain(cs: ControllerState, sim: srb_sim.SimState,
                   params: RobotParams, substeps, dt):
    """All substeps of a tick as one substep chain under the controller's
    optimized state and input; params batched. Returns (out, sim')."""
    out = substep_chain_plain(
        sim.pos, sim.quat, sim.vel, sim.omega, sim.q, sim.dq, sim.contact,
        sim.anchor, cs.ctrl.optimized_state, cs.ctrl.optimized_input,
        cs.ctrl.movement_mode, params.mass, params.mu, params.kp_foot,
        params.kd_foot, params.trunk_inertia, params.rho_fix,
        params.default_foot_pos, params.gait_counter_speed,
        sensors.contact_threshold(params), cs.ctrl.root_lin_vel_d_rel,
        substeps=substeps, dt=dt)
    return out, srb_sim.SimState(
        pos=out["pos"], quat=out["quat"], vel=out["vel"], omega=out["omega"],
        q=out["q"], dq=out["dq"], contact=out["contact"],
        anchor=out["anchor"], last_acc=out["last_acc"])


def closed_loop_tick_batched(loop: LoopState, params: RobotParams,
                             pattern: gait_mod.GaitPattern, *,
                             horizon: int = 10,
                             substeps: int = C.SUBSTEPS_PER_MPC_TICK,
                             iters: int = 15, warm=None):
    """One scenario-batched convex tick with the Feedback carried from the
    previous tick's chain (`closed_loop_tick_batched(..., solver="riccati",
    fused_substeps=True, carry_feedback=True)`): MPC prepare, the Riccati
    IPM, the substep chain, the Feedback unpacked from its block. Returns
    (loop', warm')."""
    dt_ll = C.MPC_DT / substeps
    cs, warm = convex_mpc.mpc_tick_batched(
        loop.controller, params, pattern, C.MPC_DT, horizon=horizon,
        iters=iters, solver="riccati", warm=warm)
    out, sim = _substep_chain(cs, loop.sim, params, substeps, dt_ll)
    cs = unpack_fused_feedback(cs, sim, out, params)
    return LoopState(controller=cs, sim=sim), warm


def closed_loop_tick_lci_batched(loop: LoopState, lci_state,
                                 params: RobotParams, stand_policy,
                                 walk_policy, t, *,
                                 substeps: int = C.SUBSTEPS_PER_MPC_TICK):
    """One scenario-batched tick through the LCI-MPC backend on flat ground
    (`closed_loop_tick_lci_batched(..., fused_substeps=True)`, kf_type 0):
    feedback, the seam with its batched walk policy, the substep chain.
    `params` are shared by the batch. Returns (loop', lci_state')."""
    dt_ll = C.MPC_DT / substeps
    pb = broadcast_params(params, loop.sim.pos.shape[0])
    grf_n = _anchored_normal_force(loop.controller.ctrl.joint_tau_tgt,
                                   loop.sim, pb)
    cs = feedback_update(loop.controller, _sim_sensors(loop.sim, pb, grf_n),
                         pb)
    cs, lci_state = lci_mpc.lci_mpc_tick_batched(
        cs, lci_state, stand_policy, walk_policy, t, C.MPC_DT)
    out, sim = _substep_chain(cs, loop.sim, pb, substeps, dt_ll)
    cs = cs.replace(ctrl=cs.ctrl.replace(
        joint_ang_tgt=out["q_tgt"], joint_vel_tgt=out["dq_tgt"],
        joint_tau_tgt=out["tau_ff"]))
    return LoopState(controller=cs, sim=sim), lci_state


def init_loop_batch(params: RobotParams, batch: int,
                    generator: torch.Generator, height_range=(0.27, 0.32),
                    dtype=torch.float32, body_height=0.3,
                    draw_dtype=None) -> LoopState:
    """Batch of standing initial states with heights drawn uniformly from
    `height_range` by `generator` (`parallel/runner.init_loop_batch`), on
    the generator's device. The heights are drawn and scaled in
    `draw_dtype` (default `dtype`) and then cast to `dtype`."""
    device = generator.device
    draw_dtype = dtype if draw_dtype is None else draw_dtype
    u = torch.rand((batch,), generator=generator, dtype=draw_dtype,
                   device=device)
    heights = (height_range[0] + (height_range[1] - height_range[0]) * u
               ).to(dtype)
    return LoopState(
        controller=controller_init(params, batch, dtype, device,
                                   body_height),
        sim=srb_sim.sim_init(params, heights, dtype, device))


def shard_seed(seed: int, gidx: int) -> int:
    """The generator seed of global shard `gidx` of a sweep seeded `seed`
    (`parallel/distributed.shard_seed`)."""
    return int(np.random.SeedSequence([seed, gidx]).generate_state(
        1, np.uint64)[0])
