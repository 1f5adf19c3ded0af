"""Sensor processing (`legged_mpc_control_tpu/control/sensors.py`, the
reference's BaseInterface::sensor_update, BaseInterface.cpp:212-402):
orientation products, per-leg FK/Jacobian in every frame, contact detection
and the GRF estimate from joint torques. Batch-first.
"""

import torch

from benchmark.reference.config import RobotParams
from benchmark.reference.models import kinematics as kin
from benchmark.reference.ops import la3, so3
from benchmark.reference.types import Feedback


def contact_threshold(params: RobotParams):
    """Foot-force contact threshold (reference: :316-329)."""
    return (params.foot_sensor_min + params.foot_sensor_ratio
            * (params.foot_sensor_max - params.foot_sensor_min))


def sensor_update(fbk: Feedback, params: RobotParams,
                  joint_ang_tgt=None, joint_vel_tgt=None) -> Feedback:
    """Recompute the derived feedback from the raw fields. The joint
    targets, when given, strip the PD command from the force estimate
    (reference: :331-350)."""
    B = fbk.root_quat.shape[0]
    R = so3.quat_to_rotmat(fbk.root_quat)
    euler = so3.quat_to_euler(fbk.root_quat)
    Rz = so3.rot_z(euler[:, 2])
    ang_vel_world = (R @ fbk.imu_ang_vel[..., None])[..., 0]

    q_legs = fbk.joint_pos.reshape(B, 4, 3)
    dq_legs = fbk.joint_vel.reshape(B, 4, 3)
    foot_pos_rel = kin.fk_legs(q_legs, params.rho_fix)
    jac = kin.jac_legs(q_legs, params.rho_fix)
    foot_vel_rel = (jac @ dq_legs[..., None])[..., 0]

    R4 = R[:, None]
    foot_pos_abs = (R4 @ foot_pos_rel[..., None])[..., 0]
    foot_vel_abs = (R4 @ foot_vel_rel[..., None])[..., 0]
    foot_pos_world = foot_pos_abs + fbk.root_pos[:, None]
    # omega x p term (reference: BaseInterface.cpp:300-301)
    omega_term = (R4 @ torch.linalg.cross(
        fbk.imu_ang_vel[:, None].expand(B, 4, 3), foot_pos_rel)[..., None]
    )[..., 0]
    foot_vel_world = foot_vel_abs + fbk.root_lin_vel[:, None] + omega_term

    thresh = contact_threshold(params)[..., None]
    contact_sig = torch.sigmoid(10.0 * (fbk.foot_force_sensor - thresh))
    contact_bool = fbk.foot_force_sensor > thresh

    tau = fbk.joint_tau_est.reshape(B, 4, 3)
    if joint_ang_tgt is not None:
        tau = tau - params.kp_foot[..., None, :] * (
            joint_ang_tgt.reshape(B, 4, 3) - q_legs)
    if joint_vel_tgt is not None:
        tau = tau - params.kd_foot[..., None, :] * (
            joint_vel_tgt.reshape(B, 4, 3) - dq_legs)
    force_world = (R4 @ la3.solve3_t(jac, tau)[..., None])[..., 0]

    return fbk.replace(
        root_rot_mat=R, root_euler=euler, root_rot_mat_z=Rz,
        root_ang_vel=ang_vel_world,
        foot_pos_rel=foot_pos_rel, foot_vel_rel=foot_vel_rel, jac_foot=jac,
        foot_pos_abs=foot_pos_abs, foot_vel_abs=foot_vel_abs,
        foot_pos_world=foot_pos_world, foot_vel_world=foot_vel_world,
        foot_contact_flag=contact_sig.to(fbk.root_pos.dtype),
        foot_contact_bool=contact_bool,
        foot_force_tau_est=force_world)
