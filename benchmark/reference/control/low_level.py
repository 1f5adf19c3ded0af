"""Low-level control (`legged_mpc_control_tpu/control/low_level.py`): GRF
-> joint torques, swing-leg IK targets and the PD law (reference:
BaseInterface.cpp:451-500, GazeboInterface.cpp:99-118). Batch-first.
"""

import torch

from benchmark.reference.config import RobotParams
from benchmark.reference.models import kinematics as kin
from benchmark.reference.ops import la3


def tau_ctrl_update(fbk, optimized_state, optimized_input, movement_mode,
                    params: RobotParams):
    """Joint targets and feed-forward torques, each (B, 12)."""
    B = optimized_state.shape[0]
    Rt = fbk.root_rot_mat.transpose(-1, -2)[:, None]            # (B,1,3,3)
    grf_rel = (Rt @ optimized_input[:, 0:12].reshape(B, 4, 3, 1))[..., 0]
    # tau = -J^T f (reference: :459)
    tau = -(fbk.jac_foot.transpose(-1, -2) @ grf_rel[..., None])[..., 0]

    walking = (movement_mode > 0)[:, None, None]
    foot_target_world = optimized_state[:, 6:18].reshape(B, 4, 3)
    foot_vel_target_world = optimized_input[:, 12:24].reshape(B, 4, 3)
    foot_target_rel = (Rt @ (foot_target_world
                             - fbk.root_pos[:, None])[..., None])[..., 0]
    vel_err = foot_vel_target_world - fbk.root_lin_vel[:, None]
    foot_vel_target_rel = (Rt @ vel_err[..., None])[..., 0]

    q_meas = fbk.joint_pos.reshape(B, 4, 3)
    dq_meas = fbk.joint_vel.reshape(B, 4, 3)
    q_ik = kin.ik_legs(foot_target_rel, q_meas, params.rho_fix)
    q_ik = torch.where(torch.isnan(q_ik), q_meas, q_ik)        # (:472-478)
    dq_ik = la3.solve3(fbk.jac_foot, foot_vel_target_rel)
    dq_ik = torch.where(torch.isnan(dq_ik), dq_meas, dq_ik)
    q_tgt = torch.where(walking, q_ik, q_meas)
    dq_tgt = torch.where(walking, dq_ik, dq_meas)
    return q_tgt.reshape(B, 12), dq_tgt.reshape(B, 12), tau.reshape(B, 12)


def pd_torque(joint_pos, joint_vel, joint_ang_tgt, joint_vel_tgt,
              joint_tau_tgt, params: RobotParams):
    """Kp (q_d - q) + Kd (dq_d - dq) + tau_ff, gains per axis and shared by
    the legs (reference: GazeboInterface.cpp:107-110)."""
    def per_joint(g):                     # (..., 3) -> (..., 12)
        return g.tile((1,) * (g.dim() - 1) + (4,))
    kp, kd = per_joint(params.kp_foot), per_joint(params.kd_foot)
    return (kp * (joint_ang_tgt - joint_pos)
            + kd * (joint_vel_tgt - joint_vel) + joint_tau_tgt)
