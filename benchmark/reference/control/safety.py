"""Safety envelope (`legged_mpc_control_tpu/control/safety.py`, reference:
LeggedSafetyChecker.hpp:17-32): |roll| <= 1 rad, |pitch| <= 3 rad, max
joint velocity <= 30 rad/s. An unsafe scenario gets zero torques.
"""

import torch

ROLL_LIMIT = 1.0
PITCH_LIMIT = 3.0
JOINT_VEL_LIMIT = 30.0


def is_safe(root_euler, joint_vel):
    return ((root_euler[..., 0].abs() <= ROLL_LIMIT)
            & (root_euler[..., 1].abs() <= PITCH_LIMIT)
            & (joint_vel.amax(dim=-1) <= JOINT_VEL_LIMIT))


def gate_torques(tau, safe):
    """Zero the torques of unsafe scenarios (GazeboInterface.cpp:80-87)."""
    return torch.where(safe[..., None], tau, torch.zeros_like(tau))
