"""The condensed convex-MPC QP and its OSQP-style ADMM solve, in plain
PyTorch: a frozen copy of the port's `mpc/qp_builder.build_condensed_qp`
and `mpc/admm.solve_qp_admm_batched`, with `torch.linalg.cholesky_ex` and
`torch.cholesky_solve` in place of kernels K4 and K5, and the friction
pyramid's operators of `mpc/riccati.py` (the port's `mpc/pdip.py` ones).

The states are eliminated from the reference's sparse QP over
[u_0, x_1, ..., x_H] (ConvexQPSolver.cpp:60-128, 286-305): a dense QP in
U = [u_0 .. u_{H-1}] in R^{12H},

    min_U  1/2 U^T P U + q^T U   s.t. per (step, leg) friction pyramid and
                                 normal-force box on that leg's 3 forces
    P = S^T Qbar S + Rbar,   q = S^T Qbar (c - Xref)

solved as OSQP does (ConvexQPSolver.cpp:182-185), after Jacobi scaling
u = D x, D = diag(P)^(-1/2), and unit-row-norm equilibration of the scaled
constraint blocks, by a fixed number of iterations of

    solve  (P~ + sigma I + rho G~^T G~) x_t = sigma x - q~ + G~^T (rho z - y)
    x  <- alpha x_t + (1 - alpha) x
    z  <- clip(G~ x + y / rho, -inf, h~)
    y  <- y + rho (G~ x - z)

with one factor of the constant matrix a solve. Matrix products run in
full float32 (TF32 off): P = S^T Q S in TF32 comes out indefinite.
"""

from typing import NamedTuple

import torch

from benchmark.reference.constants import DIM_GRF, GRAVITY, MPC_STATE_DIM
from benchmark.reference.mpc.riccati import N_CON_PER_LEG, _g_local, _h_vec


class CondensedQP(NamedTuple):
    """Dense condensed QP plus the separable constraint data, batch-first."""
    P: torch.Tensor          # (B, 12H, 12H)
    q: torch.Tensor          # (B, 12H)
    contact: torch.Tensor    # (B, H, 4) contact schedule in {0., 1.}
    mu: torch.Tensor         # scalar or (B,)
    fz_max: torch.Tensor     # scalar or (B,)


class AdmmResult(NamedTuple):
    u: torch.Tensor        # (B, 12H) forces over the horizon (N)
    warm: tuple            # (x, z, y) scaled state for the next solve


def _full_float32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_condensed_qp(x0, x_ref, A_seq, Bm, contact, q_weights, r_weights,
                       mu, fz_max, dt) -> CondensedQP:
    """x0 (B,12); x_ref (B,H,12); A_seq (B,H,12,12); Bm (B,12,12); contact
    (B,H,4); q_weights / r_weights (B,12); mu, fz_max (B,); dt the MPC
    step."""
    _full_float32()
    B, H = x_ref.shape[0], x_ref.shape[1]
    dtype, dev = x_ref.dtype, x_ref.device

    # Ad_k = I + dt C_k with C_k C_j = 0: Phi_{k,j} = I + dt sum C_m
    M_seq = A_seq[:, :, 0:3, 6:9] / dt
    Mcum = torch.cumsum(M_seq, dim=1)

    leg_mask = contact.repeat_interleave(3, dim=-1)
    Bt = Bm[:, None, 6:9, :] * leg_mask[:, :, None, :]
    Bf = Bm[:, None, 9:12, :] * leg_mask[:, :, None, :]

    U = torch.einsum("bkxy,bjyc->bkjxc", Mcum, Bt)
    V = torch.einsum("bjxy,bjyc->bjxc", Mcum, Bt)
    ks = torch.arange(H, dtype=dtype, device=dev)
    kmj = ks[:, None] - ks[None, :]
    tril = (kmj >= 0).to(dtype)[:, :, None, None]
    rows03 = dt * (U - V[:, None])
    rows36 = dt * kmj[:, :, None, None] * Bf[:, None]
    rows69 = Bt[:, None].expand(B, H, H, 3, DIM_GRF)
    rows912 = Bf[:, None].expand(B, H, H, 3, DIM_GRF)
    S = torch.cat([rows03, rows36, rows69, rows912], dim=3) * tril

    y0 = (A_seq[:, 0] @ x0[..., None])[..., 0]
    Msum1k = Mcum - Mcum[:, :1]
    c = y0[:, None].expand(B, H, MPC_STATE_DIM).clone()
    c[..., 0:3] += dt * torch.einsum("bkxy,by->bkx", Msum1k, y0[:, 6:9])
    c[..., 3:6] += dt * ks[:, None] * y0[:, None, 9:12]
    g_dt = GRAVITY * dt
    c[..., 11] += -(ks + 1.0) * g_dt
    c[..., 5] += -g_dt * dt * ks * (ks + 1.0) / 2.0

    Sm = S.permute(0, 1, 3, 2, 4).reshape(B, H * MPC_STATE_DIM, H * DIM_GRF)
    qbar = q_weights.expand(B, MPC_STATE_DIM).repeat(1, H)
    rbar = r_weights.expand(B, MPC_STATE_DIM).repeat(1, H)

    SQ = Sm * qbar[:, :, None]
    P = Sm.transpose(-1, -2) @ SQ + torch.diag_embed(rbar)
    P = 0.5 * (P + P.transpose(-1, -2))
    resid = (c - x_ref).reshape(B, -1)
    q = (SQ.transpose(-1, -2) @ resid[..., None])[..., 0]
    return CondensedQP(P=P, q=q, contact=contact,
                       mu=torch.as_tensor(mu, dtype=dtype, device=dev),
                       fz_max=torch.as_tensor(fz_max, dtype=dtype,
                                              device=dev))


def _block_diag_add(M, blocks, diag):
    """M + blockdiag(blocks) + diag * I for M (B, n, n) and blocks
    (B, H, 4, 3, 3), one 3x3 block per (step, leg)."""
    B, n = M.shape[0], M.shape[-1]
    K = M.clone()
    K.view(B, n // 3, 3, n // 3, 3).diagonal(dim1=1, dim2=3).add_(
        blocks.reshape(B, n // 3, 3, 3).permute(0, 2, 3, 1))
    K.diagonal(dim1=-2, dim2=-1).add_(diag)
    return K


def cholesky(K):
    """The lower Cholesky factor of K (B, n, n); NaN for a matrix that is
    not positive definite (as kernel K4's non-finite factor)."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info > 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def cho_solve(L, b):
    """x of L L^T x = b, b (B, n)."""
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def solve_qp_admm_batched(P, q, mu, fz_max, contact, *, iters=30, rho=0.1,
                          sigma=1e-6, alpha=1.6, warm=None) -> AdmmResult:
    """OSQP-style ADMM with a fixed iteration count on the batched
    condensed QP: P (B,n,n), q (B,n), contact (B,H,4), mu / fz_max (B,);
    warm: the `warm` of the previous solve, or None for a cold start."""
    _full_float32()
    B, n = q.shape
    H = n // 12
    dtype = P.dtype

    d = torch.rsqrt(torch.clamp(P.diagonal(dim1=-2, dim2=-1), min=1e-12))
    Ps = P * d[:, :, None] * d[:, None, :]
    qs = q * d

    Glb = _g_local(mu, q).expand(B, N_CON_PER_LEG, 3)
    Gb = Glb[:, None, None] * d.reshape(B, H, 4, 3)[..., None, :]
    e = torch.rsqrt(torch.clamp((Gb * Gb).sum(dim=-1), min=1e-12))
    Gb = Gb * e[..., None]
    hs = _h_vec(H, fz_max, q).expand(B, H, 4, N_CON_PER_LEG) * e
    neg = -1e20 if dtype == torch.float64 else -3e38

    def Gdot(u):
        return torch.einsum("bhlri,bhli->bhlr", Gb, u.reshape(B, H, 4, 3))

    def GTdot(w):
        return torch.einsum("bhlri,bhlr->bhli", Gb, w).reshape(B, n)

    gtg = torch.einsum("bhlri,bhlrj->bhlij", Gb, Gb)
    L = cholesky(_block_diag_add(Ps, gtg * rho, sigma))

    if warm is None:
        x = torch.zeros((B, n), dtype=dtype, device=q.device)
        z = torch.zeros((B, H, 4, N_CON_PER_LEG), dtype=dtype,
                        device=q.device)
        y = torch.zeros_like(z)
    else:
        x, z, y = warm

    for _ in range(iters):
        x_t = cho_solve(L, sigma * x - qs + GTdot(rho * z - y))
        x = alpha * x_t + (1.0 - alpha) * x
        Gx = Gdot(x)
        z2 = torch.minimum(torch.clamp(Gx + y / rho, min=neg), hs)
        y = y + rho * (Gx - z2)
        z = z2

    # swing legs' forces are exactly zero at the optimum; ADMM leaves a
    # residue there
    u = x * d * contact.reshape(B, H, 4).repeat_interleave(
        3, dim=-1).reshape(B, n)
    return AdmmResult(u=u, warm=(x, z, y))
