"""Batched ADMM (OSQP-equivalent) solver for the condensed MPC QP
(`legged_mpc_control_tpu/mpc/admm.py`), batch-first.

The reference solves its MPC QP with OSQP, an ADMM splitting with warm
starts (reference: ConvexQPSolver.cpp:182-185). Here, on the condensed QP

    min_u  1/2 u^T P u + q^T u   s.t.   G u <= h

(G block-separable, 6 rows per (step, leg) on that leg's 3 forces), after
Jacobi scaling u = D u~, D = diag(P)^(-1/2), and unit-row-norm
equilibration of the scaled constraint blocks:

    solve  (P~ + sigma I + rho G~^T G~) x_t = sigma x - q~ + G~^T (rho z - y)
    x  <- alpha x_t + (1 - alpha) x
    z  <- clip(G~ x + y / rho, -inf, h~)
    y  <- y + rho (G~ x - z)

The KKT matrix is constant over the iterations: it is factored once per
solve (kernel K4 on CUDA tensors) and every iteration is one solve (kernel
K5), `ops/chol_kernel.py`, then one launch of the ADMM step kernel for the
x, z and y updates and the next solve's right-hand side,
`ops/admm_kernel.py` (one more before the first solve for its right-hand
side). CPU tensors take the plain versions.
"""

from typing import NamedTuple

import torch

from legged_mpc_control_tpu_torch.mpc.pdip import (
    N_CON_PER_LEG,
    _block_diag_add,
    _g_local,
    _h_vec,
)
from legged_mpc_control_tpu_torch.ops import admm_kernel, chol_kernel
from legged_mpc_control_tpu_torch.utils import trace


class AdmmResult(NamedTuple):
    u: torch.Tensor        # (B, 12H) optimal GRFs over the horizon
    r_prim: torch.Tensor   # (B,) final primal residual inf-norm (scaled)
    r_dual: torch.Tensor   # (B,) final dual residual inf-norm (unscaled)
    warm: tuple            # (x, z, y) scaled state for warm-starting


@trace.spanned(trace.ADMM)
def solve_qp_admm_batched(P, q, mu, fz_max, contact, *, iters=200,
                          rho=0.1, sigma=1e-6, alpha=1.6, warm=None):
    """OSQP-style ADMM on the batched condensed QP: P (B,n,n), q (B,n),
    contact (B,H,4), mu / fz_max scalar or (B,).

    iters: fixed iteration count; 200 cold iterations reach OSQP's own
    operating accuracy, warm-started re-solves across ticks need ~30.
    rho / sigma / alpha: OSQP's step, regularization and relaxation
    defaults. warm: `AdmmResult.warm` of a previous solve (valid across
    ticks: the scaling depends only on diag(P), near-constant tick to
    tick), or None for a cold start."""
    B, n = q.shape
    H = n // 12
    dtype = P.dtype

    # equilibration
    d = torch.rsqrt(torch.clamp(P.diagonal(dim1=-2, dim2=-1), min=1e-12))
    Ps = P * d[:, :, None] * d[:, None, :]
    qs = q * d

    # per-(step, leg) scaled constraint blocks G~ = E G_loc D_leg
    Glb = _g_local(mu, q).expand(B, N_CON_PER_LEG, 3)
    Gb = Glb[:, None, None] * d.reshape(B, H, 4, 3)[..., None, :]
    e = torch.rsqrt(torch.clamp((Gb * Gb).sum(dim=-1), min=1e-12))
    Gb = Gb * e[..., None]                                # (B,H,4,6,3)
    hs = _h_vec(H, fz_max, q).expand(B, H, 4, N_CON_PER_LEG) * e
    neg = -1e20 if dtype == torch.float64 else -3e38

    # constant KKT matrix P~ + sigma I + rho G~^T G~ (3x3 block-diagonal
    # contribution per (step, leg)), factored once
    gtg = torch.einsum("bhlri,bhlrj->bhlij", Gb, Gb)
    F = chol_kernel.cholesky_cuda(_block_diag_add(Ps, gtg * rho, sigma))

    if warm is None:
        x = torch.zeros((B, n), dtype=dtype, device=q.device)
        z = torch.zeros((B, H, 4, N_CON_PER_LEG), dtype=dtype,
                        device=q.device)
        y = torch.zeros_like(z)
    else:
        x, z, y = warm

    kw = dict(rho=rho, sigma=sigma, alpha=alpha, neg=neg)
    if iters > 0:
        rhs = admm_kernel.admm_step(None, x, z, y, Gb, hs, qs, **kw)[3]
    for _ in range(iters):
        x_t = chol_kernel.cho_solve_cuda(F, rhs)
        x, z, y, rhs = admm_kernel.admm_step(x_t, x, z, y, Gb, hs, qs, **kw)

    r_prim = (admm_kernel.gdot(Gb, x) - z).reshape(B, -1).abs().amax(dim=-1)

    # unscale: u = D x; the dual residual in the original units
    u = x * d
    lam = y * e
    r_dual = ((P @ u[..., None])[..., 0] + q
              + torch.einsum("bri,bhlr->bhli", Glb, lam).reshape(B, n)
              ).abs().amax(dim=-1)

    # swing legs' forces are exactly zero at the optimum (only the R
    # penalty acts on their masked columns); ADMM leaves an O(r_prim)
    # residue there
    u = u * contact.reshape(B, H, 4).repeat_interleave(3, dim=-1).reshape(
        B, n)
    return AdmmResult(u=u, r_prim=r_prim, r_dual=r_dual, warm=(x, z, y))
