"""Kernels K4, K5 and K6 wrapper: batched Cholesky factor
(csrc/chol_factor.cu) and solves (csrc/chol_lanes.cu), the port of the TPU
kernels
`legged_mpc_control_tpu/ops/chol_pallas.py:cholesky_lanes` (K4),
`cho_solve_lanes` (K5, one right-hand side) and `cho_solve_lanes_multi`
(K6, m right-hand sides).

The TPU kernels take the batch innermost, (n, n, B), (n, B) and (n, m, B);
the port keeps its batch-first convention: K (B, n, n) SPD, b (B, n),
R (B, n, m), any n.

The factor F that `cholesky_cuda` returns holds L in its lower triangle,
diagonal included, and L^T in its strict upper triangle (F = L + L^T -
diag L), so that both triangular sweeps of `cho_solve_cuda` read rows of F,
contiguous in memory. Only the lower triangle of K is read. A
non-positive pivot gives a non-finite factor, as the TPU kernel's rsqrt
does (no clamp), which the PDIP solver's non-finite guard freezes.

`cholesky_cuda` / `cho_solve_cuda` / `cho_solve_multi_cuda` launch the
kernels on CUDA tensors (float32) and run the plain versions
`cholesky_plain` / `cho_solve_plain` / `cho_solve_multi_plain` (what the
JAX package's "xla" backend computes) on CPU tensors.
"""

import ctypes
import functools
import types

import torch

from legged_mpc_control_tpu_torch.ops import cuda_build


def cholesky_plain(K):
    """Plain version of K4: `torch.linalg.cholesky_ex`, NaN for a matrix
    that is not positive definite, L^T mirrored into the strict upper
    triangle."""
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where((info > 0)[..., None, None],
                    torch.full_like(L, float("nan")), L)
    return L + L.tril(-1).transpose(-1, -2)


def cho_solve_plain(F, b):
    """Plain version of K5: L L^T x = b by two triangular solves, L the
    lower triangle of F (B, n, n); b (B, n)."""
    L = F.tril()
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                         upper=True)[..., 0]


def cho_solve_multi_plain(F, R):
    """Plain version of K6: L L^T X = R by two triangular solves, L the
    lower triangle of F (B, n, n); R (B, n, m)."""
    L = F.tril()
    Y = torch.linalg.solve_triangular(L, R, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True)


# K6 keeps F and X in shared memory: n (n + m) floats per block
SOLVE_MULTI_SMEM_MAX = 232448
# Past n = 384 K5 keeps 8 rows of F and the right-hand side in shared
# memory: 9 n floats a block
SOLVE_N_MAX = SOLVE_MULTI_SMEM_MAX // (9 * 4)


@functools.lru_cache(maxsize=None)
def _lib():
    """Both libraries, K4's and K5/K6's, as one namespace of launchers."""
    factor = cuda_build.load("chol_factor")
    factor.chol_factor_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    factor.chol_factor_launch.restype = ctypes.c_int
    lib = cuda_build.load("chol_lanes")
    lib.chol_solve_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.chol_solve_launch.restype = ctypes.c_int
    lib.chol_solve_multi_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.chol_solve_multi_launch.restype = ctypes.c_int
    return types.SimpleNamespace(
        chol_factor_launch=factor.chol_factor_launch,
        chol_solve_launch=lib.chol_solve_launch,
        chol_solve_multi_launch=lib.chol_solve_multi_launch)


def _check(name, t, shape, dev):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA Cholesky kernels take float32 "
                        f"only, got {t.dtype}")
    if t.device.type != "cuda" or (dev is not None and t.device != dev):
        raise ValueError(f"{name}: tensor on {t.device}, want cuda (or cpu "
                         "for the plain version)")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")


def cholesky_cuda(K):
    """Batched Cholesky factor F of K (B, n, n) (kernel K4 on CUDA, the
    plain version on CPU); see the module docstring for F's layout."""
    if K.device.type == "cpu":
        return cholesky_plain(K)
    if K.dim() != 3:
        raise ValueError(f"K: want (B, n, n), got {tuple(K.shape)}")
    B, n = K.shape[0], K.shape[-1]
    _check("K", K, (B, n, n), None)
    K = K.contiguous()
    F = torch.empty_like(K)
    err = _lib().chol_factor_launch(
        K.data_ptr(), F.data_ptr(), B, n,
        torch.cuda.current_stream(K.device).cuda_stream)
    cuda_build.check(err, "chol_factor")
    cuda_build.LAUNCHES["chol_factor"] += 1
    return F


def cho_solve_cuda(F, b):
    """Solve L L^T x = b for F from `cholesky_cuda` (B, n, n) and b (B, n)
    (kernel K5 on CUDA, the plain version on CPU). Returns x (B, n)."""
    if F.device.type == "cpu":
        return cho_solve_plain(F, b)
    if F.dim() != 3:
        raise ValueError(f"F: want (B, n, n), got {tuple(F.shape)}")
    B, n = F.shape[0], F.shape[-1]
    _check("F", F, (B, n, n), None)
    _check("b", b, (B, n), F.device)
    if n > SOLVE_N_MAX:
        raise ValueError(f"K5 holds 8 rows of F and b in shared memory: "
                         f"n={n} > {SOLVE_N_MAX} does not fit")
    F, b = F.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    err = _lib().chol_solve_launch(
        F.data_ptr(), b.data_ptr(), x.data_ptr(), B, n,
        torch.cuda.current_stream(F.device).cuda_stream)
    cuda_build.check(err, "chol_solve")
    cuda_build.LAUNCHES["chol_solve"] += 1
    return x


def cho_solve_multi_cuda(F, R):
    """Solve L L^T X = R for F from `cholesky_cuda` (B, n, n) and m
    right-hand sides R (B, n, m) (kernel K6 on CUDA, the plain version on
    CPU). Returns X (B, n, m)."""
    if F.device.type == "cpu":
        return cho_solve_multi_plain(F, R)
    if F.dim() != 3 or R.dim() != 3:
        raise ValueError(f"F, R: want (B, n, n), (B, n, m), got "
                         f"{tuple(F.shape)}, {tuple(R.shape)}")
    B, n, m = R.shape
    _check("F", F, (B, n, n), None)
    _check("R", R, (B, n, m), F.device)
    if 4 * n * (n + m) > SOLVE_MULTI_SMEM_MAX:
        raise ValueError(f"K6 holds F and X in shared memory: n={n}, m={m} "
                         "does not fit")
    F, R = F.contiguous(), R.contiguous()
    X = torch.empty_like(R)
    err = _lib().chol_solve_multi_launch(
        F.data_ptr(), R.data_ptr(), X.data_ptr(), B, n, m,
        torch.cuda.current_stream(F.device).cuda_stream)
    cuda_build.check(err, "chol_solve_multi")
    cuda_build.LAUNCHES["chol_solve_multi"] += 1
    return X
