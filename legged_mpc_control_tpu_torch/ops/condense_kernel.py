"""The condensed QP's build kernel's wrapper: P and q of
`mpc/qp_builder.build_condensed_qp` in one launch (csrc/condense.cu), from
the per-step factors, in float64, P written once. It replaces no TPU
kernel: the JAX package builds P = S^T Q S as a dense matrix product
(`legged_mpc_control_tpu/mpc/qp_builder.py`).

`condense` launches the kernel on CUDA tensors, which have to be float32
and within the horizon its shared memory takes (`max_horizon()`, 64): it
raises ValueError on any other CUDA input. CPU tensors run the plain
version `condense_plain` (`build_condensed_qp`'s former torch operations),
which float64 references on the card call by name.
`cuda_build.LAUNCHES["condense"]` counts the launches.
"""

import ctypes
import functools

import torch

from legged_mpc_control_tpu_torch.constants import (
    DIM_GRF,
    GRAVITY,
    MPC_STATE_DIM,
)
from legged_mpc_control_tpu_torch.ops import cuda_build

def _per_scenario(w, B, like):
    """(12,) or (B, 12) weights as (B, 12)."""
    return torch.as_tensor(w, dtype=like.dtype,
                           device=like.device).expand(B, MPC_STATE_DIM)


def condense_plain(x0, x_ref, A_seq, Bm, contact, q_weights, r_weights, dt):
    """Plain version of the build kernel, in the inputs' dtype (P's sums in
    float64 from float32). Returns (P (B, 12H, 12H), q (B, 12H))."""
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
    return P, q


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("condense")
    lib.condense_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_double] * 2 + [ctypes.c_void_p])
    lib.condense_launch.restype = ctypes.c_int
    lib.condense_max_h.restype = ctypes.c_int
    return lib


def max_horizon():
    """The largest horizon the kernel takes (its shared memory's)."""
    return _lib().condense_max_h()


def _check(name, t, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name}: tensor on {t.device}, want {dev}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    return t.contiguous()


def _weights(name, w, B, dev):
    """(12,) or (B, 12) weights (or any shape that expands to it) as float32
    rows and their stride."""
    w = torch.as_tensor(w, dtype=torch.float32, device=dev)
    if w.dim() == 1:
        return _check(name, w, (MPC_STATE_DIM,), dev), 0
    return (_check(name, w.expand(B, MPC_STATE_DIM), (B, MPC_STATE_DIM), dev),
            MPC_STATE_DIM)


def condense(x0, x_ref, A_seq, Bm, contact, q_weights, r_weights, dt):
    """(P, q) of the condensed QP (`qp_builder.build_condensed_qp`'s
    arguments): the plain version on CPU tensors, the kernel on CUDA ones,
    which have to be float32 with H <= max_horizon() (ValueError else).
    The kernel's P is exactly symmetric."""
    B, H = x_ref.shape[0], x_ref.shape[1]
    tensors = (x0, x_ref, A_seq, Bm, contact)
    if not any(t.is_cuda for t in tensors):
        return condense_plain(x0, x_ref, A_seq, Bm, contact, q_weights,
                              r_weights, dt)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("condense: the kernel takes float32 CUDA tensors, "
                         f"not {[str(t.dtype) for t in tensors]}")
    if H > max_horizon():
        raise ValueError(f"condense: horizon {H} over the kernel's largest, "
                         f"{max_horizon()}")
    dev, n = x_ref.device, MPC_STATE_DIM * H
    x_ref = _check("x_ref", x_ref, (B, H, MPC_STATE_DIM), dev)
    x0 = _check("x0", x0, (B, MPC_STATE_DIM), dev)
    A_seq = _check("A_seq", A_seq, (B, H, MPC_STATE_DIM, MPC_STATE_DIM), dev)
    Bm = _check("Bm", Bm, (B, MPC_STATE_DIM, DIM_GRF), dev)
    contact = _check("contact", contact, (B, H, 4), dev)
    qw, qs = _weights("q_weights", q_weights, B, dev)
    rw, rs = _weights("r_weights", r_weights, B, dev)
    P = torch.empty((B, n, n), dtype=torch.float32, device=dev)
    q = torch.empty((B, n), dtype=torch.float32, device=dev)
    err = _lib().condense_launch(
        x0.data_ptr(), x_ref.data_ptr(), A_seq.data_ptr(), Bm.data_ptr(),
        contact.data_ptr(), qw.data_ptr(), rw.data_ptr(), qs, rs,
        P.data_ptr(), q.data_ptr(), B, H, float(dt), GRAVITY,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "condense")
    cuda_build.LAUNCHES["condense"] += 1
    return P, q
