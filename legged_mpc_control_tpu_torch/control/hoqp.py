"""Hierarchical QP with inequality tiers (`legged_mpc_control_tpu/control/
hoqp.py`), the reference's recursive null-space HoQp (HoQp.cpp:147-174).
Batch-first. Each priority level solves

    min_{z, v}  || A_k (x_prev + Z_prev z) - b_k ||^2 + || v ||^2
    s.t.        v >= 0
                D_j (x_prev + Z_prev z) <= f_j + v_j*   for j < k
                D_k (x_prev + Z_prev z) - v <= f_k

then descends into the null space of A_k Z_prev. Each level is a
fixed-iteration infeasible-start Mehrotra interior-point solve
(`solve_ineq_qp`); the null basis keeps a fixed width n, an SVD zeroing
the non-null columns instead of dropping them, so contact-dependent rank
changes never change shapes. Inactive task rows are zeroed, not removed.
"""

from typing import NamedTuple, Sequence

import torch


class HoTask(NamedTuple):
    """One priority level, batch-first. Inactive rows are zeroed (A row and
    b; D row and f): a zero row is trivially satisfied."""
    A: torch.Tensor      # (B, ka, n) equality rows, or (B, 0, n)
    b: torch.Tensor      # (B, ka)
    D: torch.Tensor      # (B, kd, n) inequality rows D x <= f, or (B, 0, n)
    f: torch.Tensor      # (B, kd)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _cholesky_nan(K):
    """Cholesky factor, NaN where a matrix is not positive definite (as
    the JAX package's `jnp.linalg.cholesky`), which freezes the scenario."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info > 0)[:, None, None],
                       torch.full_like(L, float("nan")), L)


def solve_ineq_qp(Hm, c, D, f, *, iters=20, tol=None, x0=None):
    """min 1/2 x^T H x + c^T x  s.t.  D x <= f, dense and small: Hm
    (B, n, n) PSD (callers add Tikhonov damping), c (B, n), D (B, m, n),
    f (B, m). Infeasible-start Mehrotra predictor-corrector with a fixed
    iteration count; a scenario freezes once converged or non-finite, and
    the loop stops once every scenario has frozen (the iterations left
    would change nothing). Returns x (B, n)."""
    B, n = c.shape
    m = D.shape[-2]
    dtype, dev = Hm.dtype, Hm.device
    f64 = dtype == torch.float64
    if tol is None:
        tol = 1e-11 if f64 else 1e-6
    d_max = 1e14 if f64 else 1e6
    reg = 1e-11 if f64 else 1e-6
    eps = 1e-30 if f64 else 1e-20
    Dt = D.transpose(-1, -2)
    eye = torch.eye(n, dtype=dtype, device=dev)

    x = torch.zeros((B, n), dtype=dtype, device=dev) if x0 is None else x0
    s = torch.clamp(f - _mv(D, x), min=1.0)
    lam = torch.ones((B, m), dtype=dtype, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)

    def max_step(v, dv):
        neg = dv < 0
        ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0),
                            torch.full_like(v, float("inf")))
        return torch.clamp(ratio.amin(-1), max=1.0)

    for _ in range(iters):
        r_dual = _mv(Hm, x) + c + _mv(Dt, lam)
        r_prim = _mv(D, x) + s - f
        mu_gap = (s * lam).sum(-1) / m
        s_safe = torch.clamp(s, min=eps)
        d = torch.clamp(lam / s_safe, 0.0, d_max)
        K = Hm + Dt @ (d[..., None] * D) + eye * reg
        L = _cholesky_nan(K)

        def solve_dir(rc):
            w = (lam * r_prim - rc) / s_safe
            rhs = -(r_dual + _mv(Dt, w))
            dx = torch.cholesky_solve(rhs[..., None], L)[..., 0]
            ds = -(r_prim + _mv(D, dx))
            dlam = -(rc + lam * ds) / s_safe
            return dx, ds, dlam

        dx_a, ds_a, dl_a = solve_dir(lam * s)
        a_p = max_step(s, ds_a)[:, None]
        a_d = max_step(lam, dl_a)[:, None]
        mu_aff = ((s + a_p * ds_a) * (lam + a_d * dl_a)).sum(-1) / m
        sigma = torch.clamp((mu_aff / torch.clamp(mu_gap, min=eps)) ** 3,
                            1e-4, 0.9)
        gap10 = 10.0 * mu_gap[:, None]
        corr = torch.maximum(torch.minimum(ds_a * dl_a, gap10), -gap10)
        dx, ds, dlam = solve_dir(lam * s + corr
                                 - (sigma * mu_gap)[:, None])
        a_p = 0.99 * max_step(s, ds)[:, None]
        a_d = 0.99 * max_step(lam, dlam)[:, None]

        conv = (mu_gap < tol) & (r_prim.abs().amax(-1) < 1e3 * tol)
        bad = ~(torch.isfinite(dx).all(-1) & torch.isfinite(ds).all(-1)
                & torch.isfinite(dlam).all(-1))
        done = done | conv | bad
        keep = done[:, None]
        x = torch.where(keep, x, x + a_p * dx)
        s = torch.where(keep, s, s + a_p * ds)
        lam = torch.where(keep, lam, lam + a_d * dlam)
        if bool(done.all()):
            break
    return x


def soft_nullspace(A, tol=1e-8):
    """Fixed-width null basis of A (B, k, n): (B, n, n) with the non-null
    columns zeroed. Right singular vectors whose singular value is below
    tol * s_max (or that have none, n > k) span the null space. The basis
    torch's SVD returns may differ from another library's by a rotation
    within the null space; the hierarchy's solution does not depend on
    it. A matrix with a non-finite entry gets an all-NaN basis, as in the
    JAX package, and leaves the batch's other scenarios as they are
    (torch's SVD refuses a non-finite input, so it is given zeros)."""
    k, n = A.shape[-2:]
    bad = ~torch.isfinite(A).all(-1).all(-1)
    _, sv, vh = torch.linalg.svd(
        torch.where(bad[:, None, None], torch.zeros_like(A), A),
        full_matrices=True)
    smax = torch.clamp(sv[:, :1], min=1.0)
    mask = torch.cat([(sv < tol * smax).to(A.dtype),
                      torch.ones((A.shape[0], n - min(k, n)), dtype=A.dtype,
                                 device=A.device)], -1)
    basis = vh.transpose(-1, -2) * mask[:, None, :]
    return torch.where(bad[:, None, None],
                       torch.full_like(basis, float("nan")), basis)


def hoqp_solve(tasks: Sequence[HoTask], n: int, *, iters=20, damping=1e-9):
    """Resolve the whole priority hierarchy (highest first; the reference
    builds HoQp(task_2, HoQp(task_1, HoQp(task_0))) inside out,
    wbc.cpp:99-102). Returns the decision vector x (B, n)."""
    A0 = tasks[0].A
    B, dtype, dev = A0.shape[0], A0.dtype, A0.device
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    x = torch.zeros((B, n), dtype=dtype, device=dev)
    Z = eye_n.expand(B, n, n)
    stacked = []                # [(D_j, f_j + v_j*)] of the solved levels

    def zeros(*shape):
        return torch.zeros((B,) + shape, dtype=dtype, device=dev)

    def neg_eye(k):
        return -torch.eye(k, dtype=dtype, device=dev).expand(B, k, k)

    for t in tasks:
        ka, kd = t.A.shape[-2], t.D.shape[-2]
        M = t.A @ Z                                        # (B, ka, n)
        # objective over (z, v): ||M z - (b - A x)||^2 + ||v||^2
        H_zz = M.transpose(-1, -2) @ M + damping * eye_n
        c_z = _mv(M.transpose(-1, -2), _mv(t.A, x) - t.b)

        rows_D, rows_V, rhs = [], [], []
        if kd:
            rows_D.append(zeros(kd, n))                    # -v <= 0
            rows_V.append(neg_eye(kd))
            rhs.append(zeros(kd))
        for Dj, fj in stacked:                             # earlier, relaxed
            rows_D.append(Dj @ Z)
            rows_V.append(zeros(Dj.shape[-2], kd))
            rhs.append(fj - _mv(Dj, x))
        if kd:
            rows_D.append(t.D @ Z)                         # D x - v <= f
            rows_V.append(neg_eye(kd))
            rhs.append(t.f - _mv(t.D, x))

        if rows_D:
            Dhat = torch.cat([torch.cat([rd, rv], -1)
                              for rd, rv in zip(rows_D, rows_V)], -2)
            fhat = torch.cat(rhs, -1)
            Hm = zeros(n + kd, n + kd)
            Hm[:, :n, :n] = H_zz
            if kd:
                Hm[:, n:, n:] = torch.eye(kd, dtype=dtype, device=dev)
            c = torch.cat([c_z, zeros(kd)], -1)
            sol = solve_ineq_qp(Hm, c, Dhat, fhat, iters=iters)
            z, v = sol[:, :n], sol[:, n:]
        else:
            # a pure equality level with nothing inherited: closed form
            z = torch.linalg.solve(H_zz, -c_z)
            v = zeros(0)

        x = x + _mv(Z, z)
        if kd:
            stacked.append((t.D, t.f + v))
        if ka:
            Z = Z @ soft_nullspace(M)
    return x
