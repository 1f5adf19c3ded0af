"""Kernel K1 wrapper: the single-launch Riccati interior-point MPC solve
(csrc/riccati_ipm.cu), the port of the TPU kernel
`legged_mpc_control_tpu/ops/riccati_pallas.py:solve_qp_riccati_fused`.

`solve_qp_riccati_cuda` has the contract of the TPU wrapper: it returns
(u (B,12H) with swing legs zeroed, gap (B,), lam (B,H,4,6)). On CUDA tensors
it launches the kernel (f32 only, any horizon, batch-first tensors read in
place); on CPU tensors it runs the plain version
`mpc/riccati.py:solve_qp_riccati_batched`.
"""

import ctypes
import functools

import torch

from legged_mpc_control_tpu_torch.ops import cuda_build
from legged_mpc_control_tpu_torch.utils import trace

NX = 12


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("riccati_ipm")
    lib.riccati_ipm_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
        + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_void_p])
    lib.riccati_ipm_launch.restype = ctypes.c_int
    lib.riccati_ipm_scratch_floats.argtypes = [ctypes.c_int]
    lib.riccati_ipm_scratch_floats.restype = ctypes.c_int
    return lib


def _check_args(x0, x_ref, A_seq, Bmat, contact, warm_u):
    if x_ref.dtype != torch.float32:
        raise TypeError("the CUDA Riccati kernel takes float32 only, got "
                        f"{x_ref.dtype}")
    if x_ref.device.type != "cuda":
        raise ValueError(f"tensors on {x_ref.device}: want cuda (or cpu "
                         "for the plain version)")
    B, H, _ = x_ref.shape
    want = {"x0": (x0, (B, NX)), "x_ref": (x_ref, (B, H, NX)),
            "A_seq": (A_seq, (B, H, NX, NX)), "Bmat": (Bmat, (B, NX, NX)),
            "contact": (contact, (B, H, 4))}
    if warm_u is not None:
        want["warm_u"] = (warm_u, (B, H * NX))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if t.dtype != torch.float32 or t.device != x_ref.device:
            raise TypeError(f"{name}: want float32 on {x_ref.device}, got "
                            f"{t.dtype} on {t.device}")


def _per_scenario(v, n, B, dev):
    """(tensor, batch stride) of a value shared by the batch (stride 0) or
    given per scenario, n floats a scenario."""
    t = torch.as_tensor(v, dtype=torch.float32, device=dev)
    if t.numel() == n:
        return t.reshape(n).contiguous(), 0
    return t.reshape(-1, n).expand(B, n).contiguous(), n


@trace.spanned(trace.K1)
def solve_qp_riccati_cuda(x0, x_ref, A_seq, Bmat, contact, q_weights,
                          r_weights, mu, fz_max, dt, *, iters=18,
                          warm_u=None):
    """One-launch Riccati IPM (kernel K1). Arguments as
    `mpc/riccati.py:solve_qp_riccati_batched`."""
    if x_ref.device.type == "cpu":
        from legged_mpc_control_tpu_torch.mpc.riccati import (
            solve_qp_riccati_batched,
        )
        return solve_qp_riccati_batched(
            x0, x_ref, A_seq, Bmat, contact, q_weights, r_weights, mu,
            fz_max, dt, iters=iters, warm_u=warm_u)
    _check_args(x0, x_ref, A_seq, Bmat, contact, warm_u)
    B, H, _ = x_ref.shape
    dev = x_ref.device
    ins = [t.contiguous() for t in (x0, x_ref, A_seq, Bmat, contact)]
    if ins[4].data_ptr() % 16:          # read by float4, a stage at a time
        ins[4] = ins[4].clone()
    (qw, qs), (rw, rs), (mu_t, ms), (fz, fs) = (
        _per_scenario(v, n, B, dev) for v, n in
        ((q_weights, NX), (r_weights, NX), (mu, 1), (fz_max, 1)))
    u0 = None if warm_u is None else warm_u.contiguous()

    lib = _lib()
    u = torch.empty((B, H * NX), dtype=torch.float32, device=dev)
    lam = torch.empty((B, H, 4, 6), dtype=torch.float32, device=dev)
    gap = torch.empty((B,), dtype=torch.float32, device=dev)
    scratch = torch.empty((B, lib.riccati_ipm_scratch_floats(H)),
                          dtype=torch.float32, device=dev)
    err = lib.riccati_ipm_launch(
        *[t.data_ptr() for t in (*ins, qw, rw, mu_t, fz)], qs, rs, ms, fs,
        None if u0 is None else u0.data_ptr(), u.data_ptr(), gap.data_ptr(),
        lam.data_ptr(), scratch.data_ptr(), B, H, int(iters), float(dt),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "riccati_ipm")
    cuda_build.LAUNCHES["riccati_ipm"] += 1
    return u, gap, lam
