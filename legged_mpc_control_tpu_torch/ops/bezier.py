"""Bezier swing-foot trajectory (`legged_mpc_control_tpu/ops/bezier.py`).

The reference's degree-4 swing curve (Utils.cpp:136-206): control points
per axis [start, start, final, final, final] with z lifts on points 1 and 2.
"""

import math

import torch

from legged_mpc_control_tpu_torch.constants import (
    FOOT_SWING_CLEARANCE1,
    FOOT_SWING_CLEARANCE2,
)

_BINOM = (1.0, 4.0, 6.0, 4.0, 1.0)


def _control_points(p_start, p_final, terrain_pitch_angle):
    """(..., 3) endpoints -> (..., 5, 3) control points."""
    lift = torch.zeros(p_start.shape[:-1] + (5, 3), dtype=p_start.dtype,
                       device=p_start.device)
    lift[..., 1, 2] = FOOT_SWING_CLEARANCE1
    lift[..., 2, 2] = (FOOT_SWING_CLEARANCE2
                       + 0.5 * math.sin(terrain_pitch_angle))
    return torch.stack([p_start, p_start, p_final, p_final, p_final],
                       dim=-2) + lift


def _bernstein(t, degree, binom):
    """(...,) phases -> (..., degree+1) Bernstein weights."""
    u = 1.0 - t
    return torch.stack([binom[i] * t ** i * u ** (degree - i)
                        for i in range(degree + 1)], dim=-1)


def swing_foot_pos(t, p_start, p_final, terrain_pitch_angle=0.0):
    """Swing-foot position at phase t (...,) in [0, 1]; p_* (..., 3).
    reference: Utils.cpp:136-176."""
    cp = _control_points(p_start, p_final, terrain_pitch_angle)  # (...,5,3)
    w = _bernstein(t, 4, _BINOM)                                 # (...,5)
    return (w[..., :, None] * cp).sum(dim=-2)


def swing_foot_pos_vel(t, p_start, p_final, swing_duration,
                       terrain_pitch_angle=0.0):
    """Position and analytic velocity d(pos)/d(wall time) of the swing
    curve, for a swing phase lasting `swing_duration` seconds. (The
    reference's analytic velocity is dead code, Utils.cpp:179-192; its
    gait FSM differentiates the position instead.)"""
    cp = _control_points(p_start, p_final, terrain_pitch_angle)
    pos = (_bernstein(t, 4, _BINOM)[..., :, None] * cp).sum(dim=-2)
    # a degree-4 Bezier's derivative: 4 sum_i B_{3,i}(t) (P_{i+1} - P_i)
    dcp = cp[..., 1:, :] - cp[..., :-1, :]
    w3 = _bernstein(t, 3, (1.0, 3.0, 3.0, 1.0))
    return pos, 4.0 * (w3[..., :, None] * dcp).sum(dim=-2) / swing_duration
