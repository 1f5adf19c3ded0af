"""Kernel K1 wrapper: the single-launch Riccati interior-point MPC solve
(csrc/riccati_ipm.cu), the port of the TPU kernel
`legged_mpc_control_tpu/ops/riccati_pallas.py:solve_qp_riccati_fused`.

`solve_qp_riccati_cuda` has the contract of the TPU wrapper: it returns
(u (B,12H) with swing legs zeroed, gap (B,), lam (B,H,4,6)). On CUDA tensors
it launches the kernel (f32 only, any horizon); on CPU tensors it runs the
plain version `mpc/riccati.py:solve_qp_riccati_batched`.
"""

import ctypes
import functools

import torch

from legged_mpc_control_tpu_torch.ops import cuda_build

NX = 12


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("riccati_ipm")
    lib.riccati_ipm_launch.argtypes = (
        [ctypes.c_void_p] * 14
        + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_int, ctypes.c_void_p])
    lib.riccati_ipm_launch.restype = ctypes.c_int
    lib.riccati_ipm_scratch_per_stage.argtypes = []
    lib.riccati_ipm_scratch_per_stage.restype = ctypes.c_int
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


def _lanes(x):
    """(B, ...) -> (..., B) contiguous: batch innermost."""
    return x.permute(*range(1, x.dim()), 0).contiguous()


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

    def per_scenario(v, shape):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=dev).expand(shape)

    x0_t = _lanes(x0)
    xref_t = _lanes(x_ref)
    A_t = _lanes(A_seq)
    B_t = _lanes(Bmat)
    c_t = _lanes(contact)
    qw_t = _lanes(per_scenario(q_weights, (B, NX)))
    rw_t = _lanes(per_scenario(r_weights, (B, NX)))
    mu_t = per_scenario(mu, (B,)).contiguous()
    fz_t = per_scenario(fz_max, (B,)).contiguous()
    u0_t = None if warm_u is None else _lanes(warm_u.reshape(B, H, NX))

    lib = _lib()
    u_t = torch.empty((H, NX, B), dtype=torch.float32, device=dev)
    lam_t = torch.empty((H, 4, 6, B), dtype=torch.float32, device=dev)
    gap = torch.empty((B,), dtype=torch.float32, device=dev)
    scratch = torch.empty((H * lib.riccati_ipm_scratch_per_stage(), B),
                          dtype=torch.float32, device=dev)
    ptrs = [x0_t, xref_t, A_t, B_t, c_t, qw_t, rw_t, mu_t, fz_t]
    err = lib.riccati_ipm_launch(
        *[t.data_ptr() for t in ptrs],
        None if u0_t is None else u0_t.data_ptr(),
        u_t.data_ptr(), gap.data_ptr(), lam_t.data_ptr(), scratch.data_ptr(),
        B, H, int(iters), float(dt), int(warm_u is not None),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "riccati_ipm")
    cuda_build.LAUNCHES["riccati_ipm"] += 1
    u = u_t.permute(2, 0, 1).reshape(B, H * NX)
    return u, gap, lam_t.permute(3, 0, 1, 2)

