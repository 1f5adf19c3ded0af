"""Condensed-horizon convex MPC QP (`legged_mpc_control_tpu/mpc/
qp_builder.py`), batch-first.

The states are eliminated from the reference's sparse QP over
[u_0, x_1, ..., x_H] (reference: ConvexQPSolver.cpp:60-128, 286-305):
substituting X_k = x_{k+1} = Ad_k X_{k-1} + Bd_k u_k + d, X_{-1} = x0, into
the tracking cost gives a dense QP in U = [u_0 .. u_{H-1}] in R^{12H}:

    min_U  1/2 U^T P U + q^T U    s.t. per (step, leg) friction pyramid and
                                  normal-force box on that leg's 3 forces
    P = S^T Qbar S + Rbar,   q = S^T Qbar (c - Xref)
    S[k,j] = Ad_k ... Ad_{j+1} Bd_j (block lower-triangular)
    c_k    = free evolution of x0 under Ad_k and d

Swing legs are gated by masking their columns out of Bd per step, so their
forces carry only the R penalty and solve to exactly 0.
`reference_sparse_qp` writes out the sparse QP itself, in float64 numpy,
for a float64 oracle to solve.

P and q are large batched matrix products outside any kernel, so
`torch.matmul` computes them, in full float32 on the card: with TF32 the
products keep ~3 decimal digits, below this QP's ~1e-4 R regularization,
and P = S^T Q S comes out indefinite (the JAX package forces
Precision.HIGHEST for the same reason). `build_condensed_qp` refuses to run
with TF32 matrix products enabled. From float32 inputs P = S^T Q S is
summed in float64 and rounded once.
"""

from typing import NamedTuple

import numpy as np
import torch

from legged_mpc_control_tpu_torch.constants import (
    DIM_GRF,
    GRAVITY,
    MPC_STATE_DIM,
    NUM_LEG,
)


class CondensedQP(NamedTuple):
    """Dense condensed QP plus the separable constraint data, batch-first."""
    P: torch.Tensor          # (B, 12H, 12H) Hessian (PSD)
    q: torch.Tensor          # (B, 12H)
    contact: torch.Tensor    # (B, H, 4) contact schedule in {0., 1.}
    mu: torch.Tensor         # friction coefficient, scalar or (B,)
    fz_max: torch.Tensor     # normal force cap, scalar or (B,)


def _per_scenario(w, B, like):
    """(12,) or (B, 12) weights as (B, 12)."""
    return torch.as_tensor(w, dtype=like.dtype,
                           device=like.device).expand(B, MPC_STATE_DIM)


def build_condensed_qp(x0, x_ref, A_seq, Bm, contact, q_weights, r_weights,
                       mu, fz_max, dt) -> CondensedQP:
    """x0 (B,12); x_ref (B,H,12), x_{k+1} tracks x_ref[k]; A_seq
    (B,H,12,12) yaw-linearized discrete A per step; Bm (B,12,12) discrete B
    at the current foot positions (the same for every step, reference:
    ConvexQPSolver.cpp:280-283); contact (B,H,4) in {0,1}; q_weights /
    r_weights (12,) or (B,12); mu, fz_max scalar or (B,); dt the MPC step."""
    if x_ref.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the condensed QP needs full float32 matrix "
                           "products: set torch.backends.cuda.matmul."
                           "allow_tf32 = False")
    B, H = x_ref.shape[0], x_ref.shape[1]
    dtype, dev = x_ref.dtype, x_ref.device

    # Ad_k = I + dt C_k with C_k = [[0, M(yaw_k)], [0, I]] on (omega, v):
    # C_k C_j = 0, so Phi_{k,j} = I + dt sum_{m=j+1..k} C_m in closed form
    M_seq = A_seq[:, :, 0:3, 6:9] / dt                    # (B,H,3,3)
    Mcum = torch.cumsum(M_seq, dim=1)                     # sum_{m<=k} M_m

    # per-step B with the swing legs' columns masked, in its two bands
    leg_mask = contact.repeat_interleave(3, dim=-1)       # (B,H,12)
    Bt = Bm[:, None, 6:9, :] * leg_mask[:, :, None, :]    # (B,H,3,12)
    Bf = Bm[:, None, 9:12, :] * leg_mask[:, :, None, :]   # (B,H,3,12)

    # S[k,j] = Phi_{k,j} B_j for j <= k:
    #   rows 0:3 = dt (Mcum[k] - Mcum[j]) Bt[j],  rows 3:6 = dt (k-j) Bf[j],
    #   rows 6:9 = Bt[j],                         rows 9:12 = Bf[j]
    U = torch.einsum("bkxy,bjyc->bkjxc", Mcum, Bt)        # (B,H,H,3,12)
    V = torch.einsum("bjxy,bjyc->bjxc", Mcum, Bt)         # (B,H,3,12)
    ks = torch.arange(H, dtype=dtype, device=dev)
    kmj = ks[:, None] - ks[None, :]                       # (H,H)
    tril = (kmj >= 0).to(dtype)[:, :, None, None]
    rows03 = dt * (U - V[:, None])
    rows36 = dt * kmj[:, :, None, None] * Bf[:, None]
    rows69 = Bt[:, None].expand(B, H, H, 3, DIM_GRF)
    rows912 = Bf[:, None].expand(B, H, H, 3, DIM_GRF)
    S = torch.cat([rows03, rows36, rows69, rows912], dim=3) * tril

    # free evolution: y0 = Ad_0 x0;
    # c_k = Phi'_k y0 + (k+1) d - g dt^2 k(k+1)/2 e5
    y0 = (A_seq[:, 0] @ x0[..., None])[..., 0]            # (B,12)
    Msum1k = Mcum - Mcum[:, :1]                           # sum_{m=1..k}
    c = y0[:, None].expand(B, H, MPC_STATE_DIM).clone()
    c[..., 0:3] += dt * torch.einsum("bkxy,by->bkx", Msum1k, y0[:, 6:9])
    c[..., 3:6] += dt * ks[:, None] * y0[:, None, 9:12]
    g_dt = GRAVITY * dt
    c[..., 11] += -(ks + 1.0) * g_dt
    c[..., 5] += -g_dt * dt * ks * (ks + 1.0) / 2.0

    # (12H, 12H): rows are states (k), columns inputs (j)
    Sm = S.permute(0, 1, 3, 2, 4).reshape(B, H * MPC_STATE_DIM, H * DIM_GRF)
    qbar = _per_scenario(q_weights, B, x_ref).repeat(1, H)     # (B,12H)
    rbar = _per_scenario(r_weights, B, x_ref).repeat(1, H)

    SQ = Sm * qbar[:, :, None]
    # float32 sums over the 12H state rows round P by ~7 ulp, which the
    # Hessian's least eigenvalues (1e-4 of its largest, Jacobi-scaled, at
    # H=30) carry into the solution: the product accumulates in float64
    acc = torch.float64 if dtype == torch.float32 else dtype
    Sa = Sm.to(acc)
    P = Sa.transpose(-1, -2) @ (Sa * qbar.to(acc)[:, :, None])
    del Sa
    P.diagonal(dim1=-2, dim2=-1).add_(rbar)
    P = P.to(dtype)
    # exact symmetry: the Cholesky factorizations read one triangle
    P = 0.5 * (P + P.transpose(-1, -2))
    resid = (c - x_ref).reshape(B, -1)
    q = (SQ.transpose(-1, -2) @ resid[..., None])[..., 0]
    return CondensedQP(P=P, q=q, contact=contact,
                       mu=torch.as_tensor(mu, dtype=dtype, device=dev),
                       fz_max=torch.as_tensor(fz_max, dtype=dtype,
                                              device=dev))


def reference_sparse_qp(x0, x_ref, A_seq, B, contact, q_weights, r_weights,
                        mu, fz_max, dt):
    """The reference's sparse QP over z = [u_0, x_1, u_1, ..., x_H]
    (ConvexQPSolver.cpp:33-196), degenerate fz in [0, 0] swing boxes
    included, as dense float64 numpy arrays: the formulation a float64
    oracle solves. One scenario: x0 (12,), x_ref (H,12), A_seq (H,12,12),
    B (12,12), contact (H,4), weights (12,), mu and fz_max scalars; numpy
    or CPU tensors. Returns (Hs, g, Ac, lb, ub) for
    min 1/2 z' Hs z + g' z  s.t.  lb <= Ac z <= ub."""
    def arr(v):
        return np.asarray(v, dtype=np.float64)

    x0, x_ref, A_seq, B = arr(x0), arr(x_ref), arr(A_seq), arr(B)
    contact, qw, rw = arr(contact), arr(q_weights), arr(r_weights)
    mu, fz_max = float(mu), float(fz_max)
    H = x_ref.shape[0]
    stride = MPC_STATE_DIM + DIM_GRF
    n = stride * H

    def u_off(k):
        return k * stride

    def x_off(k):            # x_{k+1}
        return k * stride + DIM_GRF

    # the Hessian alternates R and Q on its diagonal (:33-50); the
    # gradient is -Q x_ref[k] at x_{k+1} (:308)
    hdiag = np.zeros(n)
    g = np.zeros(n)
    for k in range(H):
        hdiag[u_off(k):u_off(k) + DIM_GRF] = rw
        hdiag[x_off(k):x_off(k) + MPC_STATE_DIM] = qw
        g[x_off(k):x_off(k) + MPC_STATE_DIM] = -qw * x_ref[k]
    Hs = np.diag(hdiag)

    n_dyn = MPC_STATE_DIM * H
    n_fr = 4 * NUM_LEG * H
    m = n_dyn + n_fr + NUM_LEG * H
    Ac, lb, ub = np.zeros((m, n)), np.zeros(m), np.zeros(m)

    # dynamics: B u_k - x_{k+1} + A_k x_k = -d (x_0 moved to the bounds)
    grav = GRAVITY * float(dt)
    for k in range(H):
        r = k * MPC_STATE_DIM
        Ac[r:r + 12, u_off(k):u_off(k) + 12] = B
        Ac[r:r + 12, x_off(k):x_off(k) + 12] = -np.eye(12)
        if k == 0:
            rhs = -A_seq[0] @ x0
            rhs[11] += grav
            lb[r:r + 12] = ub[r:r + 12] = rhs
        else:
            Ac[r:r + 12, x_off(k - 1):x_off(k - 1) + 12] = A_seq[k]
            lb[r + 11] = ub[r + 11] = grav

    # friction pyramid fx +- mu fz, fy +- mu fz, and the normal-force box
    # [0, contact fz_max] of every (step, leg)
    INF = 1e20
    for k in range(H):
        for leg in range(NUM_LEG):
            r = n_dyn + 16 * k + 4 * leg
            cx = u_off(k) + 3 * leg
            for i, (axis, sign) in enumerate(((0, 1), (0, -1), (1, 1),
                                              (1, -1))):
                Ac[r + i, cx + axis] = 1.0
                Ac[r + i, cx + 2] = sign * mu
                lb[r + i], ub[r + i] = (0.0, INF) if sign > 0 else (-INF,
                                                                    0.0)
            rb = n_dyn + n_fr + NUM_LEG * k + leg
            Ac[rb, cx + 2] = 1.0
            ub[rb] = contact[k, leg] * fz_max
    return Hs, g, Ac, lb, ub
