"""Riccati-structured batched interior-point MPC solver
(`legged_mpc_control_tpu/mpc/riccati.py`).

Solves the stagewise QP

    min  sum_k 1/2 (x_{k+1} - xref_k)^T Q (x_{k+1} - xref_k) + 1/2 u_k^T R u_k
    s.t. x_{k+1} = A_k x_k + B_k u_k + d       (gravity affine, reference:
                                                ConvexQPSolver.cpp:174-177)
         G(mu) u_k <= h_k                       (friction pyramid + fz box)

with a Mehrotra predictor-corrector whose Newton systems are solved by a
time-varying LQR Riccati sweep: H factorizations of 12x12, no condensing.

`solve_qp_riccati_batched` is the plain PyTorch version of the hand-written
kernel in `ops/riccati_kernel.py` (kernel K1): batch-first tensors,
`torch.linalg.cholesky_ex`/`cholesky_solve` per stage, Python loops for the
stage scans; `solve_qp_riccati` calls it.
"""

import functools
from typing import NamedTuple

import torch

from benchmark.reference.constants import GRAVITY

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


NX = 12


def _bcast_weights(w, B, like):
    return torch.as_tensor(w, dtype=like.dtype,
                           device=like.device).expand(B, NX)


def _mv(A, x):
    """A @ x for A (B,n,n), x (B,n)."""
    return (A @ x[..., None])[..., 0]


def _mtv(A, x):
    """A^T @ x."""
    return (A.transpose(-1, -2) @ x[..., None])[..., 0]


def _stage_data(x_ref, Bmat, contact, dt):
    legmask = contact.repeat_interleave(3, dim=-1)          # (B,H,12)
    B_seq = Bmat[:, None] * legmask[:, :, None, :]          # (B,H,12,12)
    d_aff = torch.zeros(NX, dtype=x_ref.dtype, device=x_ref.device)
    d_aff[NX - 1] = -GRAVITY * dt
    return legmask, B_seq, d_aff


def _rollout(x0, A_seq, B_seq, u, d_aff):
    """x_1..x_H under the stage dynamics: (B,H,12)."""
    x, X = x0, []
    for k in range(A_seq.shape[1]):
        x = _mv(A_seq[:, k], x) + _mv(B_seq[:, k], u[:, k]) + d_aff
        X.append(x)
    return torch.stack(X, dim=1)


def _adjoint(A_seq, qx):
    """psi_k = qx_k + A_{k+1}^T psi_{k+1}, zero past the horizon."""
    H = A_seq.shape[1]
    psi = [None] * H
    p = qx[:, H - 1]
    psi[H - 1] = p
    for k in range(H - 2, -1, -1):
        p = qx[:, k] + _mtv(A_seq[:, k + 1], p)
        psi[k] = p
    return torch.stack(psi, dim=1)


def dual_residual_batched(u, lam, x0, x_ref, A_seq, Bmat, contact,
                          q_weights, r_weights, mu, dt):
    """Max-abs stationarity residual r = R u + B^T psi + G^T lam of the
    stagewise QP at (u (B,12H), lam (B,H,4,6)): (B,)."""
    B, H, _ = x_ref.shape
    _, B_seq, d_aff = _stage_data(x_ref, Bmat, contact, dt)
    qw = _bcast_weights(q_weights, B, x_ref)
    rw = _bcast_weights(r_weights, B, x_ref)
    u_st = u.reshape(B, H, NX)
    X = _rollout(x0, A_seq, B_seq, u_st, d_aff)
    psi = _adjoint(A_seq, qw[:, None] * (X - x_ref))
    bt_psi = (B_seq.transpose(-1, -2) @ psi[..., None])[..., 0]
    r = u_st * rw[:, None] + bt_psi + _gt_apply(lam, mu).reshape(B, H, NX)
    return r.reshape(B, -1).abs().amax(dim=-1)


def warm_shift(u_prev, contact):
    """Cross-tick warm start: shift the previous tick's inputs one stage
    forward, repeat the last stage, zero swing legs under the new schedule
    (the role of OSQP's setWarmStart, ConvexQPSolver.cpp:185).
    u_prev (B, 12H) -> (B, 12H)."""
    B, H = contact.shape[0], contact.shape[1]
    u = u_prev.reshape(B, H, NX)
    u = torch.cat([u[:, 1:], u[:, -1:]], dim=1)
    return (u * contact.repeat_interleave(3, dim=-1)).reshape(B, H * NX)


def _cholesky(M):
    """Lower Cholesky; NaN where M is not positive definite (the solver's
    non-finite guard then freezes that scenario)."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info > 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def solve_qp_riccati_batched(x0, x_ref, A_seq, Bmat, contact, q_weights,
                             r_weights, mu, fz_max, dt, *, iters=18,
                             tol=None, warm_u=None):
    """Plain version of kernel K1: the batched stagewise interior-point
    solve.

    Args:
      x0 (B,12); x_ref (B,H,12), tracked by x_{k+1}; A_seq (B,H,12,12);
      Bmat (B,12,12), shared by the stages; contact (B,H,4) in {0, 1} masks
      the swing legs' B columns; q_weights/r_weights (12,) or (B,12);
      mu, fz_max scalar or (B,); dt the MPC step; warm_u optional (B,12H)
      previous solution, already `warm_shift`-ed.

    Returns (u (B,12H) with swing legs zeroed, gap (B,), lam (B,H,4,6)).
    """
    B, H, _ = x_ref.shape
    f64 = x_ref.dtype == torch.float64
    m = H * 4 * N_CON_PER_LEG
    if tol is None:
        tol = 1e-11 if f64 else 1e-6
    d_max = 1e14 if f64 else 1e6
    reg = 1e-11 if f64 else 1e-6
    eps = 1e-30 if f64 else 1e-20

    qw = _bcast_weights(q_weights, B, x_ref)
    rw = _bcast_weights(r_weights, B, x_ref)
    legmask, B_seq, d_aff = _stage_data(x_ref, Bmat, contact, dt)
    h = _h_vec(H, fz_max, x_ref).expand(B, H, 4, 6)
    eye = torch.eye(NX, dtype=x_ref.dtype, device=x_ref.device)
    qdiag = eye * qw[:, None, :]                            # (B,12,12)
    A_T = A_seq.transpose(-1, -2)
    B_T = B_seq.transpose(-1, -2)

    def Gdot(u):
        return _g_apply(u.reshape(B, H, 4, 3), mu)

    def GTdot(w):
        return _gt_apply(w, mu).reshape(B, H, NX)

    def factor(Hu):
        Ls, Ks, Huxs = [None] * H, [None] * H, [None] * H
        P = torch.zeros_like(qdiag)
        for k in range(H - 1, -1, -1):
            W = P + qdiag
            BW = B_T[:, k] @ W
            Huu = Hu[:, k] + BW @ B_seq[:, k]
            Hux = BW @ A_seq[:, k]
            L = _cholesky(Huu)
            K = -torch.cholesky_solve(Hux, L)
            P = A_T[:, k] @ W @ A_seq[:, k] + Hux.transpose(-1, -2) @ K
            P = 0.5 * (P + P.transpose(-1, -2))
            Ls[k], Ks[k], Huxs[k] = L, K, Hux
        return Ls, Ks, Huxs

    def lqr_solve(caches, g):
        Ls, Ks, Huxs = caches
        kff = [None] * H
        p = torch.zeros_like(x0)
        for k in range(H - 1, -1, -1):
            gtot = g[:, k] + _mv(B_T[:, k], p)
            kff[k] = -torch.cholesky_solve(gtot[..., None], Ls[k])[..., 0]
            p = _mv(A_T[:, k], p) + _mtv(Huxs[k], kff[k])
        du, dx = [], torch.zeros_like(x0)
        for k in range(H):
            duk = kff[k] + _mv(Ks[k], dx)
            dx = _mv(A_seq[:, k], dx) + _mv(B_seq[:, k], duk)
            du.append(duk)
        return torch.stack(du, dim=1)

    def dual_residual(u, lam):
        X = _rollout(x0, A_seq, B_seq, u, d_aff)
        psi = _adjoint(A_seq, qw[:, None] * (X - x_ref))
        return u * rw[:, None] + GTdot(lam) + (B_T @ psi[..., None])[..., 0]

    if warm_u is None:
        u = torch.zeros((B, H, NX), dtype=x_ref.dtype, device=x_ref.device)
        s = torch.clamp(h - Gdot(u), min=1.0)
        lam = torch.ones_like(s)
    else:
        u = warm_u.reshape(B, H, NX) * legmask
        s = torch.clamp(h - Gdot(u), min=0.1)
        lam = torch.clamp(1.0 / s, 1e-3, 1e2)

    def max_step(v, dv):
        ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0),
                            torch.full_like(v, float("inf")))
        return torch.clamp(ratio.reshape(B, -1).amin(dim=-1), max=1.0)

    def bc(x):
        return x[:, None, None, None]

    def finite(x):
        return torch.isfinite(x.reshape(B, -1)).all(dim=-1)

    done = torch.zeros((B,), dtype=torch.bool, device=x_ref.device)
    for _ in range(iters):
        r_dual = dual_residual(u, lam)                      # (B,H,12)
        r_prim = Gdot(u) + s - h                            # (B,H,4,6)
        mu_gap = (s * lam).sum(dim=(1, 2, 3)) / m           # (B,)

        dscale = torch.clamp(lam / torch.clamp(s, min=eps), 0.0, d_max)
        blocks = _gtdg_blocks(dscale, mu)                   # (B,H,4,3,3)
        Hu = torch.zeros((B, H, NX, NX), dtype=x_ref.dtype,
                         device=x_ref.device)
        for leg in range(4):
            Hu[:, :, 3 * leg:3 * leg + 3, 3 * leg:3 * leg + 3] = \
                blocks[:, :, leg]
        Hu = Hu + eye * (rw[:, None, None, :] + reg)
        caches = factor(Hu)

        def solve_dir(rc):
            w = (lam * r_prim - rc) / torch.clamp(s, min=eps)
            du = lqr_solve(caches, r_dual + GTdot(w))
            ds = -(r_prim + Gdot(du))
            dlam = -(rc + lam * ds) / torch.clamp(s, min=eps)
            return du, ds, dlam

        du_a, ds_a, dl_a = solve_dir(lam * s)
        a_p = max_step(s, ds_a)
        a_d = max_step(lam, dl_a)
        mu_aff = ((s + bc(a_p) * ds_a) * (lam + bc(a_d) * dl_a)).sum(
            dim=(1, 2, 3)) / m
        sigma = torch.clamp((mu_aff / torch.clamp(mu_gap, min=eps)) ** 3,
                            1e-4, 0.9)
        corr = torch.maximum(torch.minimum(ds_a * dl_a, 10.0 * bc(mu_gap)),
                             -10.0 * bc(mu_gap))
        rc = lam * s + corr - bc(sigma) * bc(mu_gap)
        du, ds, dlam = solve_dir(rc)
        a_p = 0.99 * max_step(s, ds)
        a_d = 0.99 * max_step(lam, dlam)

        # all three residuals gate the freeze: a warm start can hold tiny
        # complementarity with an unconverged dual residual
        conv = ((mu_gap < tol)
                & (r_prim.reshape(B, -1).abs().amax(dim=-1) < 1e3 * tol)
                & (r_dual.reshape(B, -1).abs().amax(dim=-1) < 1e3 * tol))
        bad = ~(finite(du) & finite(ds) & finite(dlam))
        done = done | conv | bad
        u = torch.where(done[:, None, None], u, u + a_p[:, None, None] * du)
        s = torch.where(bc(done), s, s + bc(a_p) * ds)
        lam = torch.where(bc(done), lam, lam + bc(a_d) * dlam)

    u = u * legmask
    gap = (s * lam).sum(dim=(1, 2, 3)) / m
    return u.reshape(B, H * NX), gap, lam


def solve_qp_riccati(x0, x_ref, A_seq, Bmat, contact, q_weights, r_weights,
                     mu, fz_max, dt, *, iters=18, warm_u=None,
                     diagnostics=True):
    """The plain stagewise Riccati IPM (`solve_qp_riccati_batched`).

    diagnostics: evaluate the real dual residual of the result with one
    rollout + adjoint; False reports -1 (the 100 Hz hot loop)."""

    u, gap, lam = solve_qp_riccati_batched(
        x0, x_ref, A_seq, Bmat, contact, q_weights, r_weights, mu, fz_max,
        dt, iters=iters, warm_u=warm_u)
    if diagnostics:
        r_dual = dual_residual_batched(u, lam, x0, x_ref, A_seq, Bmat,
                                       contact, q_weights, r_weights, mu, dt)
    else:
        r_dual = torch.full_like(gap, -1.0)
    return PdipResult(u=u, gap=gap, r_dual=r_dual, iters=iters)
