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

On CUDA inputs one hand-written kernel computes P and q straight from the
per-step factors, in float64, and writes P once and exactly symmetric
(csrc/condense.cu, `ops/condense_kernel.py`); it takes float32 and a horizon
up to 64, and the build raises ValueError on any other CUDA input. CPU
inputs take its plain version, `condense_kernel.condense_plain`, which
builds S and takes the products with `torch.matmul` (float64 references on
the card call it by name). On the card it needs full float32 products: with
TF32 they keep ~3 decimal digits, below this QP's ~1e-4 R regularization,
and P = S^T Q S comes out indefinite (the JAX package forces
Precision.HIGHEST for the same reason), so it refuses to run there with
TF32 matrix products enabled. From float32 inputs both sum P = S^T Q S in
float64 and round it once.
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
from legged_mpc_control_tpu_torch.ops import condense_kernel


class CondensedQP(NamedTuple):
    """Dense condensed QP plus the separable constraint data, batch-first."""
    P: torch.Tensor          # (B, 12H, 12H) Hessian (PSD)
    q: torch.Tensor          # (B, 12H)
    contact: torch.Tensor    # (B, H, 4) contact schedule in {0., 1.}
    mu: torch.Tensor         # friction coefficient, scalar or (B,)
    fz_max: torch.Tensor     # normal force cap, scalar or (B,)


def build_condensed_qp(x0, x_ref, A_seq, Bm, contact, q_weights, r_weights,
                       mu, fz_max, dt) -> CondensedQP:
    """x0 (B,12); x_ref (B,H,12), x_{k+1} tracks x_ref[k]; A_seq
    (B,H,12,12) yaw-linearized discrete A per step; Bm (B,12,12) discrete B
    at the current foot positions (the same for every step, reference:
    ConvexQPSolver.cpp:280-283); contact (B,H,4) in {0,1}; q_weights /
    r_weights (12,) or (B,12); mu, fz_max scalar or (B,); dt the MPC step."""
    P, q = condense_kernel.condense(x0, x_ref, A_seq, Bm, contact,
                                    q_weights, r_weights, dt)
    dtype, dev = x_ref.dtype, x_ref.device
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
