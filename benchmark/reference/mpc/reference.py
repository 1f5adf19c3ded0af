"""MPC reference rollout and linearization (`legged_mpc_control_tpu/mpc/
reference.py`, the reference's ConvexQPSolver::calc_mpc_reference,
ConvexQPSolver.cpp:254-313). Batch-first: every input has a leading
scenario axis.
"""

from typing import NamedTuple

import torch

from benchmark.reference.models import srb


class MpcCmd(NamedTuple):
    """Desired-motion command for the MPC, each (B, 3)."""
    root_pos_d: torch.Tensor          # only z (body height) is tracked
    root_euler_d: torch.Tensor        # desired roll/pitch (yaw integrated)
    root_lin_vel_d_rel: torch.Tensor  # body-frame velocity command
    root_ang_vel_d_rel: torch.Tensor  # body-frame rate command


def build_reference(root_euler, root_pos, root_rot_mat, cmd: MpcCmd,
                    horizon: int, dt):
    """Returns (x_ref (B,H,12), yaw_ref (B,H), lin_vel_d_world (B,3)).
    x_{k+1} tracks x_ref[:, k] (reference: ConvexQPSolver.cpp:260-276)."""
    dtype, device = root_pos.dtype, root_pos.device
    lin_vel_d_world = (root_rot_mat
                       @ cmd.root_lin_vel_d_rel[..., None])[..., 0]
    k = torch.arange(horizon, dtype=dtype, device=device)
    B = root_pos.shape[0]

    def const(v):
        return v[:, None].expand(B, horizon)

    yaw_ref = root_euler[:, 2:3] + cmd.root_ang_vel_d_rel[:, 2:3] * dt * k
    x_ref = torch.stack([
        const(cmd.root_euler_d[:, 0]),
        const(cmd.root_euler_d[:, 1]),
        yaw_ref,
        root_pos[:, 0:1] + lin_vel_d_world[:, 0:1] * dt * k,
        root_pos[:, 1:2] + lin_vel_d_world[:, 1:2] * dt * k,
        const(cmd.root_pos_d[:, 2]),
        const(cmd.root_ang_vel_d_rel[:, 0]),
        const(cmd.root_ang_vel_d_rel[:, 1]),
        const(cmd.root_ang_vel_d_rel[:, 2]),
        const(lin_vel_d_world[:, 0]),
        const(lin_vel_d_world[:, 1]),
        torch.zeros((B, horizon), dtype=dtype, device=device),
    ], dim=-1)
    return x_ref, yaw_ref, lin_vel_d_world


def build_linearization(yaw_ref, mass, trunk_inertia, root_rot_mat,
                        foot_pos_abs, dt):
    """(A_seq (B,H,12,12), Bmat (B,12,12)).
    reference: ConvexQPSolver.cpp:198-228."""
    return (srb.discrete_A(yaw_ref, dt),
            srb.discrete_B(mass, trunk_inertia, root_rot_mat, foot_pos_abs,
                           dt))
