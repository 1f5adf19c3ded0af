"""Damped-least-squares inverse kinematics on the full floating-base model
(`legged_mpc_control_tpu/models/ik_dls.py`), the reference's
`LeggedIKSolver` (LeggedIKSolver.cpp:129-160: numerical DLS IK, up to 50
iterations, stop tolerance 1e-4, warm-started). Batch-first.

A fixed trip count with a per-scenario convergence mask instead of an
early break: converged scenarios stop moving. The Jacobian is
`torch.func.jacfwd` of the whole-body FK (`models/whole_body.py`) under
`vmap`. The analytic 3-DoF IK (`models/kinematics.py`) stays the live
controller's path.
"""

import torch
from torch.func import jacfwd, vmap

from legged_mpc_control_tpu_torch.models import whole_body as wb

DAMPING = 1e-6      # Levenberg damping (the reference's 1e-9 is for f64)
EPS = 1e-4          # stop tolerance on the position residual
MAX_ITERS = 50


def _dls(q, e, J, damping, eps, done):
    """One masked DLS step q + J^T (J J^T + damping I)^-1 e per scenario;
    returns (q', done')."""
    k = J.shape[-2]
    JJt = J @ J.transpose(-1, -2) + damping * torch.eye(
        k, dtype=J.dtype, device=J.device)
    dq = (J.transpose(-1, -2) @ torch.linalg.solve(JJt, e)[..., None])[..., 0]
    new_done = torch.linalg.vector_norm(e, dim=-1) < eps
    return torch.where(done[:, None], q, q + dq), done | new_done


def ik_feet(q_init, base_pose, foot_pos_world_des, model: wb.WbModel,
            iters: int = MAX_ITERS, damping: float = DAMPING,
            eps: float = EPS):
    """Joint angles that put all four feet on world targets.

    q_init (B,12) warm start; base_pose (B,6) [base pos, euler (yaw,
    pitch, roll)], held fixed (only the joints iterate, as the reference
    masks its update to the leg block); foot_pos_world_des (B,4,3).
    Returns (q (B,12), err (B,4,3) final residual, converged (B,))."""
    base_pose = base_pose.to(q_init.dtype)

    def residual(qj, base, des):          # over leading axes: (..., 4, 3)
        return des - wb.foot_positions(torch.cat([base, qj], -1), model)

    jac = vmap(jacfwd(residual))
    qj = q_init
    done = torch.zeros(q_init.shape[0], dtype=torch.bool,
                       device=q_init.device)
    for _ in range(iters):
        e = residual(qj, base_pose, foot_pos_world_des).flatten(1)
        Jf = -jac(qj, base_pose, foot_pos_world_des).reshape(-1, 12, 12)
        qj, done = _dls(qj, e, Jf, damping, eps, done)
    err = residual(qj, base_pose, foot_pos_world_des)
    return qj, err, torch.linalg.vector_norm(err.flatten(1), dim=-1) < eps


def ik_single_leg(q_leg_init, base_pose, leg: int, foot_pos_world_des,
                  model: wb.WbModel, q_other=None, iters: int = MAX_ITERS,
                  damping: float = DAMPING, eps: float = EPS):
    """The 3-DoF variant of one leg (the reference's `solveIK` works on one
    3-joint block, LeggedIKSolver.cpp:129-160). q_leg_init (B,3); leg in
    {0, 1, 2, 3}; foot_pos_world_des (B,3); q_other (B,12) the other legs'
    angles (zeros when None). Returns (q_leg (B,3), err (B,3),
    converged (B,))."""
    B = q_leg_init.shape[0]
    if q_other is None:
        q_other = torch.zeros((B, 12), dtype=q_leg_init.dtype,
                              device=q_leg_init.device)
    base_pose = base_pose.to(q_leg_init.dtype)

    def residual(qleg, base, other, des):
        qj = torch.cat([other[..., :3 * leg], qleg,
                        other[..., 3 * leg + 3:]], -1)
        feet = wb.foot_positions(torch.cat([base, qj], -1), model)
        return des - feet[..., leg, :]

    jac = vmap(jacfwd(residual))
    qleg = q_leg_init
    done = torch.zeros(B, dtype=torch.bool, device=q_leg_init.device)
    for _ in range(iters):
        e = residual(qleg, base_pose, q_other, foot_pos_world_des)
        J = -jac(qleg, base_pose, q_other, foot_pos_world_des)
        qleg, done = _dls(qleg, e, J, damping, eps, done)
    err = residual(qleg, base_pose, q_other, foot_pos_world_des)
    return qleg, err, torch.linalg.vector_norm(err, dim=-1) < eps
