"""Single-rigid-body MPC linearization
(`legged_mpc_control_tpu/models/srb.py`).

State x = [rpy(3), pos(3), omega_world(3), v_world(3)]
(reference: ConvexQPSolver.cpp:198-228, 256-259):

    Ad = I + Ac dt,  Ac[0:3, 6:9] = M(yaw),  Ac[3:6, 9:12] = I
    Bd = Bc dt,      Bc[6:9, 3i:3i+3] = I_world^-1 [p_i]x,
                     Bc[9:12, 3i:3i+3] = I / m

Gravity enters as the affine term -g dt on the v_z row.
"""

import torch

from legged_mpc_control_tpu_torch.constants import MPC_STATE_DIM
from legged_mpc_control_tpu_torch.ops import la3
from legged_mpc_control_tpu_torch.ops.so3 import angvel_to_rpy_rate, skew


def discrete_A(yaw_ref, dt):
    """Ad(yaw): yaw_ref (...,) -> (..., 12, 12)."""
    m = angvel_to_rpy_rate(yaw_ref)
    A = torch.eye(MPC_STATE_DIM, dtype=m.dtype, device=m.device).expand(
        m.shape[:-2] + (MPC_STATE_DIM, MPC_STATE_DIM)).clone()
    A[..., 0:3, 6:9] = m * dt
    A[..., 3:6, 9:12] = torch.eye(3, dtype=m.dtype, device=m.device) * dt
    return A


def discrete_B(mass, trunk_inertia, root_rot_mat, foot_pos_abs, dt):
    """Bd for the 4-leg GRF input. mass (B,), trunk_inertia (B,3,3),
    root_rot_mat (B,3,3), foot_pos_abs (B,4,3) -> (B,12,12)."""
    R = root_rot_mat
    I_inv = la3.inv3(R @ trunk_inertia @ R.transpose(-1, -2))
    torque_blocks = I_inv[..., None, :, :] @ skew(foot_pos_abs)  # (B,4,3,3)
    Bm = torch.zeros(R.shape[:-2] + (MPC_STATE_DIM, 12), dtype=R.dtype,
                     device=R.device)
    eye3 = torch.eye(3, dtype=R.dtype, device=R.device)
    for i in range(4):
        Bm[..., 6:9, 3 * i:3 * i + 3] = torque_blocks[..., i, :, :] * dt
        Bm[..., 9:12, 3 * i:3 * i + 3] = (eye3 / mass[..., None, None]) * dt
    return Bm

