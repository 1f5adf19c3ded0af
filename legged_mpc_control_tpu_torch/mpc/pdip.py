"""Batched primal-dual interior-point solver for the condensed MPC QP
(`legged_mpc_control_tpu/mpc/pdip.py`), and the friction-pyramid constraint
operators it shares with the Riccati and ADMM solvers.

`solve_qp_pdip_batched` is a Mehrotra predictor-corrector method with a
fixed iteration count: scenarios that converge (or whose directions go
non-finite) freeze. `solve_qp_pdip` solves one QP, the single-robot tick's,
as a batch of one. Each iteration factors the Newton matrix
P + G^T D G + reg I once (kernel K4 on CUDA tensors) and solves it twice
(kernel K5), `ops/chol_kernel.py`; CPU tensors take the plain versions.
G is never built: its 6 rows per (step, leg) touch only that leg's forces.

Constraint rows per (step k, leg l) on the forces u = (fx, fy, fz)
(reference: ConvexQPSolver.cpp:130-177):
    -fx - mu fz <= 0,  fx - mu fz <= 0,  -fy - mu fz <= 0,  fy - mu fz <= 0,
     fz <= fz_max,    -fz <= 0
i.e. G(mu) = GA + mu GB per leg.
"""

import functools
from typing import NamedTuple

import torch

from legged_mpc_control_tpu_torch.ops import chol_kernel

N_CON_PER_LEG = 6

_GA = ((-1.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, -1.0, 0.0),
       (0.0, 1.0, 0.0), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))
_GB = ((0.0, 0.0, -1.0),) * 4 + ((0.0, 0.0, 0.0),) * 2


class PdipResult(NamedTuple):
    u: torch.Tensor         # (B, 12H) optimal GRFs over the horizon
    gap: torch.Tensor       # (B,) final mean complementarity
    r_dual: torch.Tensor    # (B,) final dual residual inf-norm (-1: skipped)
    iters: int              # iterations run


def _bmu(mu, out_ndim, like):
    """Scalar or (B,) mu shaped to broadcast against an out_ndim tensor."""
    mu = torch.as_tensor(mu, dtype=like.dtype, device=like.device)
    return mu.reshape(mu.shape + (1,) * (out_ndim - mu.dim()))


def _g(like):
    return _g_on(like.dtype, like.device)


@functools.lru_cache(maxsize=None)
def _g_on(dtype, device):
    """GA, GB as tensors, made once per dtype and device: building them
    from Python lists on the card is a synchronous host-to-device copy,
    and the solvers ask for them several times an iteration."""
    return (torch.tensor(_GA, dtype=dtype, device=device),
            torch.tensor(_GB, dtype=dtype, device=device))


def _g_local(mu, like):
    """G(mu) per leg: mu.shape + (6, 3); mu scalar or (B,)."""
    GA, GB = _g(like)
    mu = torch.as_tensor(mu, dtype=like.dtype, device=like.device)
    return GA + mu[..., None, None] * GB


def _g_apply(u_legs, mu):
    """G u: u_legs (..., H, 4, 3) -> (..., H, 4, 6); mu scalar or (B,)."""
    GA, GB = _g(u_legs)
    a = u_legs @ GA.T
    b = u_legs @ GB.T
    return a + _bmu(mu, a.dim(), a) * b


def _gt_apply(w, mu):
    """G^T w: w (..., H, 4, 6) -> (..., H, 4, 3)."""
    GA, GB = _g(w)
    a = w @ GA
    b = w @ GB
    return a + _bmu(mu, a.dim(), a) * b


def _gtdg_blocks(d, mu):
    """3x3 blocks of G^T diag(d) G: d (..., H, 4, 6) -> (..., H, 4, 3, 3)."""
    GA, GB = _g(d)
    aa = torch.einsum("...r,ri,rj->...ij", d, GA, GA)
    ab = torch.einsum("...r,ri,rj->...ij", d, GA, GB)
    bb = torch.einsum("...r,ri,rj->...ij", d, GB, GB)
    m = _bmu(mu, aa.dim(), aa)
    return aa + m * (ab + ab.transpose(-1, -2)) + m * m * bb


def _h_vec(H, fz_max, like):
    """RHS h of G u <= h: fz_max.shape + (H, 4, 6), fz_max on the cap row."""
    fz = torch.as_tensor(fz_max, dtype=like.dtype, device=like.device)
    e_cap = torch.zeros((6,), dtype=like.dtype, device=like.device)
    e_cap[4] = 1.0
    return fz[..., None, None, None] * e_cap.expand(H, 4, 6)


def _block_diag_add(M, blocks, diag):
    """M + blockdiag(blocks) + diag * I for M (B, n, n) and blocks
    (B, H, 4, 3, 3), one 3x3 block per (step, leg). The JAX package builds
    the dense block-diagonal matrix and adds it; here the blocks are added
    in place onto the diagonal of a copy of M. The numbers are the same."""
    B, n = M.shape[0], M.shape[-1]
    K = M.clone()
    # (B, 3, 3, n/3) view of the 3x3 diagonal blocks of K
    K.view(B, n // 3, 3, n // 3, 3).diagonal(dim1=1, dim2=3).add_(
        blocks.reshape(B, n // 3, 3, 3).permute(0, 2, 3, 1))
    K.diagonal(dim1=-2, dim2=-1).add_(diag)
    return K


def solve_qp_pdip(P, q, mu, fz_max, *, contact, iters=18, tol=None):
    """PDIP on one condensed QP: min 1/2 u^T P u + q^T u under the friction
    and force-cap rows, P (n, n), q (n,), mu and fz_max scalars, contact
    (H, 4).

    A view of `solve_qp_pdip_batched` at B=1 (kernels K4 and K5 on a CUDA
    tensor): the same iteration, with the freeze of the JAX package's
    unbatched solve, on the gap and the primal residual only. A Newton
    matrix that is not positive definite factors to NaN, and its
    non-finite direction freezes the iterate, as JAX's NaN factor does.
    Returns PdipResult with unbatched fields."""
    res = _solve(P[None], q[None], mu, fz_max, contact[None], iters=iters,
                 tol=tol, warm_u=None, dual_freeze=False)
    return PdipResult(u=res.u[0], gap=res.gap[0], r_dual=res.r_dual[0],
                      iters=iters)


def solve_qp_pdip_batched(P, q, mu, fz_max, contact, *, iters=18, tol=None,
                          warm_u=None):
    """Batched PDIP on the condensed QP: P (B,n,n), q (B,n), contact
    (B,H,4), mu / fz_max scalar or (B,). n = 12H, any H.

    warm_u: optional (B, n) previous-tick solution (shift it with
    `riccati.warm_shift` first): a primal warm start with recentered
    interior duals, the cross-tick reuse the reference gets from OSQP's
    setWarmStart(true) (ConvexQPSolver.cpp:185).

    Returns PdipResult with batched fields."""
    return _solve(P, q, mu, fz_max, contact, iters=iters, tol=tol,
                  warm_u=warm_u, dual_freeze=True)


def _solve(P, q, mu, fz_max, contact, *, iters, tol, warm_u, dual_freeze):
    """The batched iteration. dual_freeze: the dual residual gates the
    freeze too (the batched solve's rule), else the gap and the primal
    residual alone (the unbatched solve's)."""
    B, n = q.shape
    H = n // 12
    dtype = P.dtype
    f64 = dtype == torch.float64
    m = H * 4 * N_CON_PER_LEG
    if tol is None:
        tol = 1e-11 if f64 else 1e-6
    # cap on the scaling d = lambda/s: bounds cond(K) so the factorization
    # stays finite past a scenario's freeze point (float32: well inside
    # eps^-1 ~ 1e7)
    d_max = 1e14 if f64 else 1e6
    reg = 1e-11 if f64 else 1e-6
    eps = 1e-30 if f64 else 1e-20

    h = _h_vec(H, fz_max, q).expand(B, H, 4, N_CON_PER_LEG)

    def Gdot(u):
        return _g_apply(u.reshape(B, H, 4, 3), mu)

    def GTdot(w):
        return _gt_apply(w, mu).reshape(B, n)

    if warm_u is None:
        u = torch.zeros((B, n), dtype=dtype, device=q.device)
        s = torch.clamp(h - Gdot(u), min=1.0)
        lam = torch.ones_like(s)
    else:
        u = warm_u
        s = torch.clamp(h - Gdot(u), min=0.1)
        lam = torch.clamp(1.0 / s, 1e-3, 1e2)

    def bc(x):                                   # (B,) -> (B,1,1,1)
        return x[:, None, None, None]

    def max_step(v, dv):
        neg = dv < 0
        ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0),
                            torch.full_like(v, float("inf")))
        return torch.clamp(ratio.reshape(B, -1).amin(dim=-1), max=1.0)

    done = torch.zeros((B,), dtype=torch.bool, device=q.device)
    for _ in range(iters):
        r_dual = (P @ u[..., None])[..., 0] + q + GTdot(lam)
        r_prim = Gdot(u) + s - h
        mu_gap = (s * lam).sum(dim=(1, 2, 3)) / m               # (B,)

        s_safe = torch.clamp(s, min=eps)
        d = torch.clamp(lam / s_safe, 0.0, d_max)
        K = _block_diag_add(P, _gtdg_blocks(d, mu), reg)
        L = chol_kernel.cholesky_cuda(K)

        def solve_dir(rc):
            w = (lam * r_prim - rc) / s_safe
            du = chol_kernel.cho_solve_cuda(L, -(r_dual + GTdot(w)))
            ds = -(r_prim + Gdot(u + du) - Gdot(u))
            dlam = -(rc + lam * ds) / s_safe
            return du, ds, dlam

        du_a, ds_a, dl_a = solve_dir(lam * s)
        a_p = max_step(s, ds_a)
        a_d = max_step(lam, dl_a)
        mu_aff = ((s + bc(a_p) * ds_a) * (lam + bc(a_d) * dl_a)).sum(
            dim=(1, 2, 3)) / m
        sigma = torch.clamp((mu_aff / torch.clamp(mu_gap, min=eps)) ** 3,
                            1e-4, 0.9)
        lim = 10.0 * bc(mu_gap)
        corr = torch.minimum(torch.maximum(ds_a * dl_a, -lim), lim)
        rc = lam * s + corr - bc(sigma) * bc(mu_gap)
        du, ds, dlam = solve_dir(rc)

        a_p = 0.99 * max_step(s, ds)
        a_d = 0.99 * max_step(lam, dlam)

        # the batched rule: all three residuals gate the freeze (a
        # warm-started iterate can hold tiny complementarity with an
        # unconverged dual residual)
        conv = ((mu_gap < tol)
                & (r_prim.reshape(B, -1).abs().amax(dim=-1) < 1e3 * tol))
        if dual_freeze:
            conv = conv & (r_dual.abs().amax(dim=-1) < 1e3 * tol)
        # a non-finite direction (float32 factorization past the freeze
        # point) freezes the scenario at its last good iterate
        bad = ~(torch.isfinite(du).all(dim=-1)
                & torch.isfinite(ds.reshape(B, -1)).all(dim=-1)
                & torch.isfinite(dlam.reshape(B, -1)).all(dim=-1))
        done = done | conv | bad
        u = torch.where(done[:, None], u, u + a_p[:, None] * du)
        s = torch.where(bc(done), s, s + bc(a_p) * ds)
        lam = torch.where(bc(done), lam, lam + bc(a_d) * dlam)

    u = u * contact.reshape(B, H, 4).repeat_interleave(3, dim=-1).reshape(
        B, n)
    gap = (s * lam).sum(dim=(1, 2, 3)) / m
    r_dual = ((P @ u[..., None])[..., 0] + q + GTdot(lam)).abs().amax(
        dim=-1)
    return PdipResult(u=u, gap=gap, r_dual=r_dual, iters=iters)
