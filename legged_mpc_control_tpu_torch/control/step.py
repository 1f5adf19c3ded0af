"""The batched closed-loop tick (`legged_mpc_control_tpu/control/step.py`).

One MPC tick of every scenario: the reference's three threads (main.cpp:
110-256) as one function of the batched state,

    tick = [ feedback ; MPC ; 8 x (low level -> safety -> sim step ->
             sensors -> feedback) ]

with 8 = MPC_UPDATE_FREQUENCY / LOW_LEVEL_CTRL_FREQUENCY (LeggedParams.h:7-8).
The MPC solve is kernel K1 (solver "riccati") or the condensed PDIP / ADMM
solvers over kernels K4/K5 (`mpc/convex_mpc.py`); the fused substep chain is
kernel K2 (kf_type 0) or K3 (kf_type 1, the 18-state KF in every substep),
`ops/substep_kernel.py`. CPU tensors run the plain versions. On a height
field, under kf_type 2 and under low_level_type 1 the substeps run as the
per-substep loop of the ported modules (with the terrain in the sim step
and the footholds). `closed_loop_tick` is the single-robot tick (a batch
of one) through the unbatched condensed PDIP. `closed_loop_tick_wb` and
`closed_loop_tick_wb_batched` drive the articulated twin
(`sim/wb_sim.py`) through the same per-substep loop.
Ported: kf_type 0 (ground-truth feedback), 1 (the linear KF) and 2 (the
EKF, `estimation/ekf.py`); low_level_type 0 (J^T tau control) and 1 (the
hierarchical WBC, `control/wbc.py`); the contact-implicit MPC ticks (the
LCI seam of `mpc/lci_mpc.py` with its policies: the CI engine of
`mpc/ci_mpc.py` or the distilled convex walk): `closed_loop_tick_lci_batched`
for a batch, `closed_loop_tick_lci` for one robot on the SRB simulator and
`closed_loop_tick_lci_wb` for one robot on the articulated twin, with an
optional wall (the CI wall lean).
"""

from dataclasses import dataclass

import torch

from legged_mpc_control_tpu_torch import constants as C
from legged_mpc_control_tpu_torch.config import (
    RobotParams,
    param_base_ndims,
    resolve_device,
)
from legged_mpc_control_tpu_torch.control import (
    low_level,
    raibert,
    safety,
    sensors,
)
from legged_mpc_control_tpu_torch.estimation import basic_kf, ekf as ekf_mod
from legged_mpc_control_tpu_torch.models import kinematics as kin
from legged_mpc_control_tpu_torch.mpc import convex_mpc, gait as gait_mod
from legged_mpc_control_tpu_torch.mpc import lci_mpc
from legged_mpc_control_tpu_torch.ops import filters, la3, so3
from legged_mpc_control_tpu_torch.ops import substep_kernel
from legged_mpc_control_tpu_torch.sim import srb_sim, wb_sim
from legged_mpc_control_tpu_torch.tree import Struct, tree_map
from legged_mpc_control_tpu_torch.types import (
    ControllerState,
    EkfState,
    KfState,
    init_ctrl,
    init_feedback,
    init_joy,
)
from legged_mpc_control_tpu_torch.utils import trace

EKF_STATE_SIZE = ekf_mod.STATE_SIZE


@dataclass
class LoopState(Struct):
    """Carry of the closed-loop rollout: controller + simulated world."""
    controller: ControllerState
    sim: srb_sim.SimState


def controller_init(params: RobotParams, batch: int, dtype=torch.float32,
                    device="cuda", body_height=0.3) -> ControllerState:
    device = resolve_device(device)
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
        kf=KfState(x=torch.zeros((batch, basic_kf.STATE_SIZE), dtype=dtype,
                                 device=device),
                   P=eye(basic_kf.STATE_SIZE, 3.0), initialized=no()),
        ekf=EkfState(x=torch.zeros((batch, EKF_STATE_SIZE), dtype=dtype,
                                   device=device),
                     P=eye(EKF_STATE_SIZE, 1.0), initialized=no()),
        vel_filter_x=filters.moving_window_init(window, batch, dtype, device),
        vel_filter_y=filters.moving_window_init(window, batch, dtype, device),
        estimation_inited=no(), mpc_inited=no())


def _check_kf_type(kf_type):
    if kf_type not in (0, 1, 2):
        raise NotImplementedError(
            f"kf_type {kf_type} does not exist; 0 (ground truth), 1 (the "
            "linear KF) and 2 (the EKF) do")


def _check_low_level_type(low_level_type):
    if low_level_type not in (0, 1):
        raise NotImplementedError(
            f"low_level_type {low_level_type} does not exist; 0 (J^T tau "
            "control) and 1 (the WBC) do")


def _fused_ok(kf_type, low_level_type):
    """Whether the substep chain (K2, K3) serves the tick: kf_type 0 or 1
    with the J^T tau low level, as in the JAX package."""
    return kf_type in (0, 1) and low_level_type == 0


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


def _where_first(first):
    """pick(a, b): a where `first` (B,), else b, over a's trailing axes."""
    def pick(a, b):
        return torch.where(first.reshape(first.shape + (1,) * (a.dim() - 1)),
                           a, b)
    return pick


def _estimate(fbk, kf: KfState, movement_mode, dt):
    """kf_type 1 (reference: BaseInterface.cpp:407-413): one KF step on the
    sensed Feedback; a scenario's first call initializes its filter and
    keeps the root state it had. Standing scenarios trust all four feet."""
    fresh = basic_kf.kf_init(fbk.root_rot_mat, fbk.foot_pos_rel)
    contacts = torch.where((movement_mode == 0)[:, None],
                           torch.ones_like(fbk.foot_contact_flag),
                           fbk.foot_contact_flag)
    stepped, pos_est, vel_est = basic_kf.kf_update(
        kf, dt, fbk.root_rot_mat, fbk.imu_acc, fbk.imu_ang_vel,
        fbk.foot_pos_rel, fbk.foot_vel_rel, contacts)
    pick = _where_first(~kf.initialized)

    fbk = fbk.replace(root_pos=pick(fbk.root_pos, pos_est),
                      root_lin_vel=pick(fbk.root_lin_vel, vel_est),
                      estimated_contacts=contacts)
    return fbk, tree_map(pick, fresh, stepped)


def _estimate_ekf(fbk, ekf, movement_mode, dt, sensors_raw):
    """kf_type 2 (reference: BaseInterface.cpp:414-446): one EKF step on the
    sensed Feedback, fused with a mocap pose when the sensors carry
    `mocap_pos` and `mocap_euler` (GazeboInterface.cpp:147-177,
    HardwareInterface.cpp:203-228); a scenario's first call initializes
    its filter and keeps the root state it had. The attitude is estimated
    too: the orientation products come from the filtered euler angles."""
    fresh = ekf_mod.ekf_init(fbk.root_quat, fbk.root_pos, fbk.foot_pos_rel)
    contacts = torch.where((movement_mode == 0)[:, None],
                           torch.ones_like(fbk.foot_contact_flag),
                           fbk.foot_contact_flag)
    stepped, pos_est, vel_est, eul_est = ekf_mod.ekf_update(
        ekf, dt, fbk.imu_acc, fbk.imu_ang_vel, fbk.foot_pos_rel,
        fbk.foot_vel_rel, contacts)
    if "mocap_pos" in sensors_raw:
        stepped = ekf_mod.ekf_update_with_opti(
            stepped, sensors_raw["mocap_pos"], sensors_raw["mocap_euler"])
        pos_est, vel_est = stepped.x[:, 0:3], stepped.x[:, 3:6]
        eul_est = stepped.x[:, 6:9]
    pick = _where_first(~ekf.initialized)

    eul = pick(fbk.root_euler, eul_est)
    quat = so3.euler_to_quat(eul)
    R = so3.quat_to_rotmat(quat)
    fbk = fbk.replace(root_pos=pick(fbk.root_pos, pos_est),
                      root_lin_vel=pick(fbk.root_lin_vel, vel_est),
                      estimated_contacts=contacts, root_euler=eul,
                      root_quat=quat, root_rot_mat=R,
                      root_rot_mat_z=so3.rot_z(eul[:, 2]),
                      root_ang_vel=(R @ fbk.imu_ang_vel[..., None])[..., 0])
    return fbk, tree_map(pick, fresh, stepped)


def _feedback(fbk, ctrl, kf, sensors_raw, params: RobotParams, dt,
              kf_type, terrain=None):
    """Feedback-thread body on (fbk, ctrl, kf): sensors, estimation and the
    Raibert footholds (reference: BaseInterface::fbk_update,
    BaseInterface.cpp:212-449). `kf` is the state of kf_type's filter (the
    KfState under 1, the EkfState under 2). Returns (fbk, ctrl, kf)."""
    fbk = _sensed(fbk, ctrl, sensors_raw, params, ground_truth=kf_type == 0)
    if kf_type == 1:
        fbk, kf = _estimate(fbk, kf, ctrl.movement_mode, dt)
    elif kf_type == 2:
        fbk, kf = _estimate_ekf(fbk, kf, ctrl.movement_mode, dt, sensors_raw)
    target_abs, target_world = raibert.raibert_footholds(
        fbk.root_pos, fbk.root_lin_vel, fbk.root_rot_mat_z,
        ctrl.root_lin_vel_d_rel, params, terrain=terrain)
    return fbk, ctrl.replace(foot_pos_target_abs=target_abs,
                             foot_pos_target_world=target_world), kf


@trace.spanned(trace.FEEDBACK_UPDATE)
def feedback_update(cs: ControllerState, sensors_raw, params: RobotParams,
                    dt, kf_type: int = 0, terrain=None) -> ControllerState:
    """Feedback-thread body: raw sensors -> Feedback + Raibert targets, with
    kf_type 0 (ground truth), 1 (the 18-state linear KF) or 2 (the EKF; the
    sensors may carry `mocap_pos` and `mocap_euler` (B,3) to fuse); with a
    `terrain` height field the footholds snap to it."""
    _check_kf_type(kf_type)
    filt = cs.ekf if kf_type == 2 else cs.kf
    fbk, ctrl, filt = _feedback(cs.fbk, cs.ctrl, filt, sensors_raw, params,
                                dt, kf_type, terrain)
    filters_out = dict(ekf=filt) if kf_type == 2 else dict(kf=filt)
    return cs.replace(fbk=fbk, ctrl=ctrl, **filters_out,
                      estimation_inited=torch.ones_like(cs.estimation_inited))


def _wbc_model(wb_model, like):
    """The whole-body model the WBC linearizes against: `wb_model`, or A1's
    in the dtype and on the device of `like` (the JAX package's
    default)."""
    from legged_mpc_control_tpu_torch.models import whole_body as wb

    return (wb_model if wb_model is not None
            else wb.a1_wb_model(like.dtype, like.device))


def _lowlevel(fbk, ctrl, params: RobotParams, low_level_type: int = 0,
              wb_model=None):
    """J^T tau control (or, under low_level_type 1, the WBC's feed-forward
    torques against `wb_model`) + swing IK + PD + safety gate on
    (fbk, ctrl): returns (ctrl with the joint targets, tau (B,12),
    safe (B,))."""
    q_tgt, dq_tgt, tau_ff = low_level.tau_ctrl_update(
        fbk, ctrl.optimized_state, ctrl.optimized_input, ctrl.movement_mode,
        params)
    if low_level_type == 1:
        from legged_mpc_control_tpu_torch.control import wbc

        tau_ff, _F = wbc.wbc_from_controller(
            fbk, ctrl, _wbc_model(wb_model, fbk.root_pos))
    ctrl = ctrl.replace(joint_ang_tgt=q_tgt, joint_vel_tgt=dq_tgt,
                        joint_tau_tgt=tau_ff)
    tau = low_level.pd_torque(fbk.joint_pos, fbk.joint_vel, q_tgt, dq_tgt,
                              tau_ff, params)
    safe = safety.is_safe(fbk.root_euler, fbk.joint_vel)
    return ctrl, safety.gate_torques(tau, safe), safe


def lowlevel_update(cs: ControllerState, params: RobotParams,
                    low_level_type: int = 0, wb_model=None):
    """Control-thread body (reference: GazeboInterface.cpp:63-88):
    returns (cs', tau (B,12), safe (B,)).

    low_level_type 0: J^T tau control (BaseInterface.cpp:451-500); 1: the
    hierarchical WBC's feed-forward torques (BaseInterface.cpp:502-557)
    with the IK joint PD targets kept on top. wb_model: the
    `models.whole_body.WbModel` the WBC linearizes against (A1's when
    None)."""
    _check_low_level_type(low_level_type)
    ctrl, tau, safe = _lowlevel(cs.fbk, cs.ctrl, params, low_level_type,
                                wb_model)
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


def admm_warm_init(batch: int, horizon: int, dtype=torch.float32,
                   device="cuda"):
    """Zero ADMM warm tuple (x, z, y), the cold start in the rollout
    carry's shape (`mpc/admm.py`)."""
    device = resolve_device(device)
    z = torch.zeros((batch, horizon, 4, 6), dtype=dtype, device=device)
    return (torch.zeros((batch, 12 * horizon), dtype=dtype, device=device),
            z, z.clone())


@trace.spanned(trace.FEEDBACK_UNPACK)
def unpack_fused_feedback(cs: ControllerState, sim: srb_sim.SimState, out,
                          params: RobotParams,
                          kf_type: int = 0) -> ControllerState:
    """Rebuild the Feedback and the Raibert targets from the substep
    chain's `fb` block (FB_ROWS layout): the batched equivalent of
    `feedback_update` on the chain's final state. Under kf_type 1 the root
    state is the in-chain filter's estimate `out["kf_x"]`."""
    if not _fused_ok(kf_type, 0):
        raise ValueError(f"the substep chain serves kf_type 0 and 1, not "
                         f"{kf_type}")
    fb = out["fb"]
    B = fb.shape[0]

    def take(name, *shape):
        off, n = substep_kernel.FB_ROWS[name]
        return fb[:, off:off + n].reshape((B,) + shape if shape else (B, n))

    euler = take("euler")
    fp_abs = take("foot_pos_abs", 4, 3)
    raib_abs = take("raibert_abs", 4, 3)
    if kf_type == 1:
        root_pos, root_vel = out["kf_x"][:, 0:3], out["kf_x"][:, 3:6]
    else:
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
                          kf_type: int = 0, terrain=None,
                          substeps: int = C.SUBSTEPS_PER_MPC_TICK
                          ) -> LoopState:
    """One feedback pass from the raw sim sensors (under kf_type 1 it also
    initializes the filter): seeds the carry of a `carry_feedback` rollout,
    after which the substep chain's `fb` block keeps the Feedback current.
    `terrain`: a height field the footholds snap to, or None."""
    dt_ll = C.MPC_DT / substeps
    cs = loop.controller
    grf_n = _anchored_normal_force(cs.ctrl.joint_tau_tgt, loop.sim, params)
    cs = feedback_update(cs, _sim_sensors(loop.sim, params, grf_n), params,
                         dt_ll, kf_type=kf_type, terrain=terrain)
    return loop.replace(controller=cs)


@trace.spanned(trace.K2)
def _substep_chain(cs: ControllerState, sim: srb_sim.SimState,
                   params: RobotParams, substeps, dt, kf_type):
    """All substeps of a tick as one substep chain (kernel K2, or K3 under
    kf_type 1, on CUDA; the plain version on CPU) under the controller's
    optimized state and input; params batched. Returns (out, sim')."""
    out = substep_kernel.substep_chain_cuda(
        sim.pos, sim.quat, sim.vel, sim.omega, sim.q, sim.dq, sim.contact,
        sim.anchor, cs.ctrl.optimized_state, cs.ctrl.optimized_input,
        cs.ctrl.movement_mode, params.mass, params.mu, params.kp_foot,
        params.kd_foot, params.trunk_inertia, params.rho_fix,
        params.default_foot_pos, params.gait_counter_speed,
        sensors.contact_threshold(params), cs.ctrl.root_lin_vel_d_rel,
        substeps=substeps, dt=dt, kf_type=kf_type, kf_x=cs.kf.x,
        kf_P=cs.kf.P)
    return out, srb_sim.SimState(
        pos=out["pos"], quat=out["quat"], vel=out["vel"], omega=out["omega"],
        q=out["q"], dq=out["dq"], contact=out["contact"],
        anchor=out["anchor"], last_acc=out["last_acc"])


def _srb_world(params: RobotParams, dt, terrain):
    """The SRB simulator as the per-substep loop's world: (step(sim, tau),
    sense(cs, sim)), the foot sensor fed by the anchored legs' normal
    force under the controller's last torques."""
    def step(sim, tau):
        return srb_sim.sim_step(sim, tau, params, dt, terrain=terrain)

    def sense(cs, sim):
        grf_n = _anchored_normal_force(cs.ctrl.joint_tau_tgt, sim, params)
        return _sim_sensors(sim, params, grf_n)
    return step, sense


def _wb_world(model, params: RobotParams, dt, n_inner, terrain, wall=None):
    """The articulated twin as the per-substep loop's world (its mass
    matrices solved by K4 + K5 on CUDA tensors), with an optional
    `sim.terrain.Wall`."""
    def step(sim, tau):
        return wb_sim.wb_sim_step_batched(sim, tau, model, params, dt,
                                          n_inner=n_inner, terrain=terrain,
                                          wall=wall)

    def sense(cs, sim):
        return wb_sim.wb_read_sensors(sim)
    return step, sense


def _substep_loop(cs: ControllerState, sim, params: RobotParams, substeps,
                  dt, kf_type, terrain, world, low_level_type=0,
                  wb_model=None):
    """The substeps of a tick as the per-substep loop of the ported modules:
    low level, sim step, sensors and feedback, on `terrain` (a height
    field, or None for flat ground). `world` is the simulator as
    (step(sim, tau), sense(cs, sim)): `_srb_world` or `_wb_world`.
    Returns (cs', sim')."""
    step, sense = world
    for _ in range(substeps):
        cs, tau, _safe = lowlevel_update(cs, params, low_level_type,
                                         wb_model)
        sim = step(sim, tau)
        cs = feedback_update(cs, sense(cs, sim), params, dt,
                             kf_type=kf_type, terrain=terrain)
    return cs, sim


@trace.spanned(trace.TICK)
def closed_loop_tick(loop: LoopState, params: RobotParams,
                     pattern: gait_mod.GaitPattern, *, horizon: int = 10,
                     substeps: int = C.SUBSTEPS_PER_MPC_TICK,
                     kf_type: int = 0, low_level_type: int = 0,
                     terrain=None, pdip_iters: int = 15) -> LoopState:
    """One MPC period of one robot, the CLI's and the hardware loop's tick:
    feedback, `convex_mpc.mpc_tick` (the condensed QP through the unbatched
    `pdip.solve_qp_pdip`, cold) and the per-substep loop. `loop` carries a
    leading axis of 1 on every leaf; `params` are shared or batched by one;
    `terrain` a `sim.terrain.Terrain` height field (box-stepping, stairs)
    or None. Returns loop'."""
    _check_kf_type(kf_type)
    _check_low_level_type(low_level_type)
    dt_ll = C.MPC_DT / substeps
    params = broadcast_params(params, 1)
    cs = loop.controller
    step, sense = _srb_world(params, dt_ll, terrain)
    cs = feedback_update(cs, sense(cs, loop.sim), params, dt_ll,
                         kf_type=kf_type, terrain=terrain)
    cs = convex_mpc.mpc_tick(cs, params, pattern, C.MPC_DT, horizon=horizon,
                             pdip_iters=pdip_iters)
    cs, sim = _substep_loop(cs, loop.sim, params, substeps, dt_ll, kf_type,
                            terrain, (step, sense), low_level_type,
                            _wbc_model(None, cs.fbk.root_pos)
                            if low_level_type == 1 else None)
    return LoopState(controller=cs, sim=sim)


def closed_loop_tick_wb(loop: LoopState, params: RobotParams,
                        pattern: gait_mod.GaitPattern, model, *,
                        horizon: int = 10,
                        substeps: int = C.SUBSTEPS_PER_MPC_TICK,
                        kf_type: int = 0, low_level_type: int = 0,
                        terrain=None, pdip_iters: int = 15,
                        n_inner: int = 4) -> LoopState:
    """`closed_loop_tick` against the articulated twin (reference:
    GazeboInterface.cpp:99-118 + the Gazebo physics engine): torques act
    through full rigid-body dynamics, contact is physical and the foot
    sensor reads the contact normal force. `loop.sim` is a
    `wb_sim.WbSimState` with a leading axis of 1, `model` a
    `models.whole_body.WbModel` (the twin's robot and the WBC's model).
    Returns loop'."""
    _check_kf_type(kf_type)
    _check_low_level_type(low_level_type)
    dt_ll = C.MPC_DT / substeps
    params = broadcast_params(params, 1)
    world = _wb_world(model, params, dt_ll, n_inner, terrain)
    cs = feedback_update(loop.controller, wb_sim.wb_read_sensors(loop.sim),
                         params, dt_ll, kf_type=kf_type, terrain=terrain)
    cs = convex_mpc.mpc_tick(cs, params, pattern, C.MPC_DT, horizon=horizon,
                             pdip_iters=pdip_iters)
    cs, sim = _substep_loop(cs, loop.sim, params, substeps, dt_ll, kf_type,
                            terrain, world, low_level_type, model)
    return LoopState(controller=cs, sim=sim)


def closed_loop_tick_wb_batched(loop: LoopState, params: RobotParams,
                                pattern: gait_mod.GaitPattern, model, *,
                                horizon: int = 10,
                                substeps: int = C.SUBSTEPS_PER_MPC_TICK,
                                kf_type: int = 0, iters: int = 15,
                                solver: str = "riccati",
                                low_level_type: int = 0, n_inner: int = 4,
                                terrain=None, warm=None):
    """The scenario-batched tick against the articulated twin, the twin as
    a sweep backend: feedback, one `convex_mpc.mpc_tick_batched` for the
    batch (K1 under "riccati" on CUDA tensors), then the per-substep loop
    whose sim steps factor and solve the batch's 18x18 mass matrices with
    K4 + K5 (`sim/wb_sim.wb_sim_step_batched`; 32 launches of each a tick
    at 8 substeps x n_inner 4). `loop.sim` a batched `wb_sim.WbSimState`;
    `params` batched (`broadcast_params`); `model` shared. Returns
    (loop', warm')."""
    _check_kf_type(kf_type)
    _check_low_level_type(low_level_type)
    dt_ll = C.MPC_DT / substeps
    world = _wb_world(model, params, dt_ll, n_inner, terrain)
    cs = feedback_update(loop.controller, wb_sim.wb_read_sensors(loop.sim),
                         params, dt_ll, kf_type=kf_type, terrain=terrain)
    cs, warm = convex_mpc.mpc_tick_batched(
        cs, params, pattern, C.MPC_DT, horizon=horizon, iters=iters,
        solver=solver, warm=warm)
    cs, sim = _substep_loop(cs, loop.sim, params, substeps, dt_ll, kf_type,
                            terrain, world, low_level_type, model)
    return LoopState(controller=cs, sim=sim), warm


@trace.spanned(trace.TICK)
def closed_loop_tick_batched(loop: LoopState, params: RobotParams,
                             pattern: gait_mod.GaitPattern, *,
                             horizon: int = 10,
                             substeps: int = C.SUBSTEPS_PER_MPC_TICK,
                             kf_type: int = 0, iters: int = 15,
                             solver: str = "riccati",
                             low_level_type: int = 0, terrain=None,
                             warm=None, fused_substeps: bool = True,
                             carry_feedback: bool = False,
                             admm_rho: float = 0.1):
    """One scenario-batched closed-loop tick.

    loop: LoopState with a leading scenario axis on every leaf; params:
    RobotParams batched on every leaf (`broadcast_params`); solver:
    "riccati", "pdip" or "admm" (`convex_mpc.mpc_tick_batched`); warm: the
    previous tick's warm start (the (B, 12H) solution, or the ADMM warm
    tuple), or None; terrain: a `sim.terrain.Terrain` height field shared
    by the batch, or None for flat ground.

    fused_substeps: run the 8 substeps as one substep chain (kernel K2, or
    K3 with the in-chain KF under kf_type 1, on CUDA; the plain version on
    CPU); False runs the per-substep loop of the ported modules. A height
    field always takes the per-substep loop, whose sim step and footholds
    read it (the chain knows flat ground only), and so do kf_type 2 and
    low_level_type 1 (the chain has neither the EKF nor the WBC), as in
    the JAX package.
    carry_feedback (fused only): the previous tick's chain already left a
    complete Feedback, so the opening feedback pass is skipped (seed the
    first tick with `seed_batched_feedback`).
    admm_rho: the ADMM step (solver "admm"), `convex_mpc.mpc_tick_batched`.

    Returns (loop', warm')."""
    _check_kf_type(kf_type)
    _check_low_level_type(low_level_type)
    dt_mpc = C.MPC_DT
    dt_ll = dt_mpc / substeps
    fused = (fused_substeps and terrain is None
             and _fused_ok(kf_type, low_level_type))
    cs = loop.controller
    world = _srb_world(params, dt_ll, terrain)
    if not (carry_feedback and fused):
        cs = feedback_update(cs, world[1](cs, loop.sim), params, dt_ll,
                             kf_type=kf_type, terrain=terrain)
    cs, warm = convex_mpc.mpc_tick_batched(
        cs, params, pattern, dt_mpc, horizon=horizon, iters=iters,
        solver=solver, warm=warm, admm_rho=admm_rho)

    if fused:
        out, sim = _substep_chain(cs, loop.sim, params, substeps, dt_ll,
                                  kf_type)
        if kf_type == 1:
            # the chain's filter advanced every substep; carry it on
            cs = cs.replace(kf=cs.kf.replace(x=out["kf_x"], P=out["kf_P"]))
        if carry_feedback:
            cs = unpack_fused_feedback(cs, sim, out, params, kf_type=kf_type)
        else:
            cs = cs.replace(ctrl=cs.ctrl.replace(
                joint_ang_tgt=out["q_tgt"], joint_vel_tgt=out["dq_tgt"],
                joint_tau_tgt=out["tau_ff"]))
        return LoopState(controller=cs, sim=sim), warm

    cs, sim = _substep_loop(cs, loop.sim, params, substeps, dt_ll, kf_type,
                            terrain, world, low_level_type,
                            _wbc_model(None, cs.fbk.root_pos)
                            if low_level_type == 1 else None)
    return LoopState(controller=cs, sim=sim), warm


@trace.spanned(trace.TICK)
def closed_loop_tick_lci_batched(loop: LoopState, lci_state, params:
                                 RobotParams, stand_policy, walk_policy, t,
                                 *, substeps: int = C.SUBSTEPS_PER_MPC_TICK,
                                 kf_type: int = 0, low_level_type: int = 0,
                                 terrain=None, fused_substeps: bool = True):
    """One scenario-batched closed-loop tick through the LCI-MPC backend:
    feedback (kf_type 0 ground truth, 1 the linear KF, 2 the EKF), the
    seam (`lci_mpc.lci_mpc_tick_batched`, whose batched CI walk policy
    runs one `ci_solve_batched`), then the substeps with the J^T tau low
    level (low_level_type 0) or the WBC (1, against A1's whole-body
    model). `params` are shared by the batch (unbatched leaves); `terrain`
    a `sim.terrain.Terrain` height field or None for flat ground.

    With `fused_substeps`, on flat ground, under kf_type 0 and
    low_level_type 0 the substeps run as one substep chain (kernel K2 on
    CUDA, the plain version on CPU); otherwise as the per-substep loop
    with the filter, the low level and the terrain in the sim step and
    the footholds, as in the JAX package. kf_type 1 never takes the
    chain's in-filter variant (K3) here: the JAX tick runs the KF
    unfused. Returns (loop', lci_state')."""
    _check_kf_type(kf_type)
    _check_low_level_type(low_level_type)
    dt_mpc = C.MPC_DT
    dt_ll = dt_mpc / substeps
    pb = broadcast_params(params, loop.sim.pos.shape[0])
    world = _srb_world(pb, dt_ll, terrain)
    cs = feedback_update(loop.controller, world[1](loop.controller,
                                                   loop.sim),
                         pb, dt_ll, kf_type=kf_type, terrain=terrain)
    cs, lci_state = lci_mpc.lci_mpc_tick_batched(
        cs, lci_state, stand_policy, walk_policy, t, dt_mpc)

    if (fused_substeps and terrain is None and kf_type == 0
            and low_level_type == 0):
        out, sim = _substep_chain(cs, loop.sim, pb, substeps, dt_ll, 0)
        cs = cs.replace(ctrl=cs.ctrl.replace(
            joint_ang_tgt=out["q_tgt"], joint_vel_tgt=out["dq_tgt"],
            joint_tau_tgt=out["tau_ff"]))
        return LoopState(controller=cs, sim=sim), lci_state

    cs, sim = _substep_loop(cs, loop.sim, pb, substeps, dt_ll, kf_type,
                            terrain, world, low_level_type,
                            _wbc_model(None, cs.fbk.root_pos)
                            if low_level_type == 1 else None)
    return LoopState(controller=cs, sim=sim), lci_state


@trace.spanned(trace.TICK)
def closed_loop_tick_lci(loop: LoopState, lci_state, params: RobotParams,
                         stand_policy, walk_policy, t, *,
                         substeps: int = C.SUBSTEPS_PER_MPC_TICK,
                         kf_type: int = 0, low_level_type: int = 0,
                         terrain=None):
    """One MPC period of one robot through the LCI-MPC backend (reference:
    LciMpc::update in the MPC thread, LciMpc.cpp:45-153, main.cpp:113-121
    mpc_type 0): feedback, the single-robot seam `lci_mpc.lci_mpc_tick`
    and the per-substep loop on the SRB simulator, as the JAX package runs
    it (no substep chain), with any kf_type and low_level_type and
    `terrain` a height field or None. `loop` and `lci_state` carry a leading axis of 1
    (`lci_mpc.lci_init`); `params` are shared. The walk policy is a
    stateless batch-first one (`lci_mpc.make_walk_policy`) or a
    single-robot stateful one (`ci_mpc.make_ci_walk_policy`). Returns
    (loop', lci_state')."""
    _check_kf_type(kf_type)
    _check_low_level_type(low_level_type)
    dt_ll = C.MPC_DT / substeps
    pb = broadcast_params(params, 1)
    world = _srb_world(pb, dt_ll, terrain)
    cs = feedback_update(loop.controller, world[1](loop.controller, loop.sim),
                         pb, dt_ll, kf_type=kf_type, terrain=terrain)
    cs, lci_state = lci_mpc.lci_mpc_tick(cs, lci_state, stand_policy,
                                         walk_policy, t, C.MPC_DT)
    cs, sim = _substep_loop(cs, loop.sim, pb, substeps, dt_ll, kf_type,
                            terrain, world, low_level_type,
                            _wbc_model(None, cs.fbk.root_pos)
                            if low_level_type == 1 else None)
    return LoopState(controller=cs, sim=sim), lci_state


def closed_loop_tick_lci_wb(loop: LoopState, lci_state, params: RobotParams,
                            model, stand_policy, walk_policy, t, *,
                            substeps: int = C.SUBSTEPS_PER_MPC_TICK,
                            kf_type: int = 0, low_level_type: int = 0,
                            n_inner: int = 4, terrain=None, wall=None):
    """`closed_loop_tick_lci` against the articulated twin, optionally with
    a vertical `sim.terrain.Wall` in the world: the contact-implicit
    backend at torque level through full rigid-body dynamics, and the
    reference's CI-MPC wall lean (README.md:14) with
    `ci_mpc.make_ci_lean_policy`. `loop.sim` a `wb_sim.WbSimState` with a
    leading axis of 1, `model` the twin's robot and the WBC's model. On
    CUDA tensors each sim step's mass matrices go through K4 + K5 (32
    launches each a tick). Returns (loop', lci_state')."""
    _check_kf_type(kf_type)
    _check_low_level_type(low_level_type)
    dt_ll = C.MPC_DT / substeps
    pb = broadcast_params(params, 1)
    world = _wb_world(model, pb, dt_ll, n_inner, terrain, wall)
    cs = feedback_update(loop.controller, wb_sim.wb_read_sensors(loop.sim),
                         pb, dt_ll, kf_type=kf_type, terrain=terrain)
    cs, lci_state = lci_mpc.lci_mpc_tick(cs, lci_state, stand_policy,
                                         walk_policy, t, C.MPC_DT)
    cs, sim = _substep_loop(cs, loop.sim, pb, substeps, dt_ll, kf_type,
                            terrain, world, low_level_type, model)
    return LoopState(controller=cs, sim=sim), lci_state
