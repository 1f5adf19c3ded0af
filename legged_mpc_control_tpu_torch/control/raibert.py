"""Raibert-heuristic footholds (`legged_mpc_control_tpu/control/raibert.py`,
reference: BaseInterface.cpp:358-399): yaw-rotated default stance plus

    delta = sqrt(h/g) (v - v_d) + T_stance/4 v_d,

clamped per axis; on a height field the foothold's z snaps to the terrain
under the planned xy.
"""

import torch

from legged_mpc_control_tpu_torch.config import RobotParams
from legged_mpc_control_tpu_torch.constants import (
    FOOT_DELTA_X_LIMIT,
    FOOT_DELTA_Y_LIMIT,
)
from legged_mpc_control_tpu_torch.sim import terrain as terrain_mod


def raibert_footholds(root_pos, root_lin_vel, root_rot_mat_z,
                      root_lin_vel_d_rel, params: RobotParams, terrain=None):
    """Returns (target_abs (B,4,3), target_world (B,4,3)). With a height
    map the targets aim 2 cm below its surface (the flat-ground target
    lands ~2-3 cm under the plane too; that penetration drives the swing
    PD firmly into contact)."""
    v_d = (root_rot_mat_z @ root_lin_vel_d_rel[..., None])[..., 0]
    target_abs = (root_rot_mat_z[:, None]
                  @ params.default_foot_pos[..., None])[..., 0]
    k = torch.sqrt(root_pos[:, 2].abs() / 9.8)
    t_factor = (1.0 / params.gait_counter_speed / 2.0) / 2.0
    delta = (k[:, None] * (root_lin_vel[:, :2] - v_d[:, :2])
             + t_factor[..., None] * v_d[:, :2])
    delta = torch.stack([
        torch.clamp(delta[:, 0], -FOOT_DELTA_X_LIMIT, FOOT_DELTA_X_LIMIT),
        torch.clamp(delta[:, 1], -FOOT_DELTA_Y_LIMIT, FOOT_DELTA_Y_LIMIT),
    ], dim=-1)
    target_abs = torch.cat([target_abs[..., :2] + delta[:, None],
                            target_abs[..., 2:]], dim=-1)
    target_world = target_abs + root_pos[:, None]
    if terrain is not None:
        tz = terrain_mod.height_at(terrain, target_world[..., :2]) - 0.02
        target_world = torch.cat([target_world[..., :2], tz[..., None]], -1)
        target_abs = torch.cat([target_abs[..., :2],
                                (tz - root_pos[:, 2:3])[..., None]], -1)
    return target_abs, target_world
