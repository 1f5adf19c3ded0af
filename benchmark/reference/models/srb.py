"""Single-rigid-body MPC linearization
(`legged_mpc_control_tpu/models/srb.py`).

State x = [rpy(3), pos(3), omega_world(3), v_world(3)]
(reference: ConvexQPSolver.cpp:198-228, 256-259):

    Ad = I + Ac dt,  Ac[0:3, 6:9] = M(yaw),  Ac[3:6, 9:12] = I
    Bd = Bc dt,      Bc[6:9, 3i:3i+3] = I_world^-1 [p_i]x,
                     Bc[9:12, 3i:3i+3] = I / m

Gravity enters as the affine term -g dt on the v_z row (`gravity_affine`).
`srb_continuous_dynamics` gives the nonlinear accelerations of the same
body under world-frame foot forces.
"""

import torch

from benchmark.reference.config import resolve_device
from benchmark.reference.constants import GRAVITY, MPC_STATE_DIM
from benchmark.reference.ops import la3
from benchmark.reference.ops.so3 import angvel_to_rpy_rate, skew


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



def gravity_affine(dt, dtype=torch.float32, device="cuda"):
    """Affine term d of x_{k+1} = Ad x_k + Bd u_k + d: -g dt on v_z, (12,)."""
    d = torch.zeros((MPC_STATE_DIM,), dtype=dtype,
                    device=resolve_device(device))
    d[11] = -GRAVITY * dt
    return d


def srb_continuous_dynamics(pos, rotmat, omega_world, vel, grf_world,
                            foot_pos_world, mass, trunk_inertia):
    """Nonlinear SRB accelerations from world-frame foot forces: pos,
    omega_world, vel (B,3), rotmat (B,3,3), grf_world and foot_pos_world
    (B,4,3), mass (B,), trunk_inertia (B,3,3). Returns (v_dot, omega_dot)
    (B,3) in the world frame."""
    g = torch.zeros_like(pos)
    g[..., 2] = -GRAVITY
    v_dot = grf_world.sum(dim=-2) / mass[..., None] + g
    I_world = rotmat @ trunk_inertia @ rotmat.transpose(-1, -2)
    torque = torch.linalg.cross(foot_pos_world - pos[..., None, :],
                                grf_world).sum(dim=-2)
    Iw_om = (I_world @ omega_world[..., None])[..., 0]
    omega_dot = la3.solve3(I_world,
                           torque - torch.linalg.cross(omega_world, Iw_om))
    return v_dot, omega_dot
