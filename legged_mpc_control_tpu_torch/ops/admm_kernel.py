"""The ADMM step kernel's wrapper: the update of one iteration of
`mpc/admm.solve_qp_admm_batched` after its Cholesky solve, and the next
iteration's right-hand side, in one launch (csrc/admm_step.cu). It replaces
no TPU kernel: the JAX package runs the iteration as jnp ops
(`legged_mpc_control_tpu/mpc/admm.py`).

With x_t the solve's output, G~ (B, H, 4, 6, 3) the scaled constraint
blocks, h~ (B, H, 4, 6) their bounds and q~ (B, n) the scaled linear term:

    x   <- alpha x_t + (1 - alpha) x
    z   <- min(max(G~ x + y / rho, neg), h~)
    y   <- y + rho (G~ x - z)
    rhs  = sigma x - q~ + G~^T (rho z - y)

`admm_step` with x_t None computes only rhs from x, z, y (the first
iteration's). It launches the kernel on CUDA tensors (float32) and runs
the plain version `admm_step_plain`, the solver's torch operations, on CPU
tensors.
`cuda_build.LAUNCHES["admm_step"]` counts the launches.
"""

import ctypes
import functools

import torch

from legged_mpc_control_tpu_torch.ops import cuda_build


def gdot(Gb, u):
    """G~ u: Gb (B, H, 4, 6, 3), u (B, 12H) -> (B, H, 4, 6)."""
    B, H = Gb.shape[:2]
    return torch.einsum("bhlri,bhli->bhlr", Gb, u.reshape(B, H, 4, 3))


def gtdot(Gb, w):
    """G~^T w: Gb (B, H, 4, 6, 3), w (B, H, 4, 6) -> (B, 12H)."""
    B, H = Gb.shape[:2]
    return torch.einsum("bhlri,bhlr->bhli", Gb, w).reshape(B, 12 * H)


def admm_step_plain(x_t, x, z, y, Gb, hs, qs, *, rho, sigma, alpha, neg):
    """Plain version of the ADMM step kernel. Returns (x, z, y, rhs); x, z,
    y the inputs with x_t None."""
    if x_t is not None:
        x = alpha * x_t + (1.0 - alpha) * x
        Gx = gdot(Gb, x)
        z = torch.minimum(torch.clamp(Gx + y / rho, min=neg), hs)
        y = y + rho * (Gx - z)
    return x, z, y, sigma * x - qs + gtdot(Gb, rho * z - y)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("admm_step")
    lib.admm_step_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + [ctypes.c_float] * 5
        + [ctypes.c_void_p])
    lib.admm_step_launch.restype = ctypes.c_int
    return lib


def _check(name, t, shape, dev):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the ADMM step kernel takes float32 only, "
                        f"got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name}: tensor on {t.device}, want {dev}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    return t.contiguous()


def admm_step(x_t, x, z, y, Gb, hs, qs, *, rho, sigma, alpha, neg):
    """One ADMM update and the next right-hand side (the kernel on CUDA
    tensors, the plain version on CPU ones): x_t and x, qs (B, 12H), z, y,
    hs (B, H, 4, 6), Gb (B, H, 4, 6, 3). Returns (x, z, y, rhs) as
    `admm_step_plain`; the outputs are new tensors."""
    if Gb.device.type == "cpu":
        return admm_step_plain(x_t, x, z, y, Gb, hs, qs, rho=rho,
                               sigma=sigma, alpha=alpha, neg=neg)
    if Gb.dim() != 5:
        raise ValueError(f"Gb: want (B, H, 4, 6, 3), got {tuple(Gb.shape)}")
    B, H = Gb.shape[:2]
    dev = Gb.device
    if dev.type != "cuda":
        raise ValueError(f"Gb: tensor on {dev}, want cuda (or cpu for the "
                         "plain version)")
    Gb = _check("Gb", Gb, (B, H, 4, 6, 3), dev)
    x, qs = (_check(k, t, (B, 12 * H), dev) for k, t in (("x", x),
                                                          ("qs", qs)))
    z, y, hs = (_check(k, t, (B, H, 4, 6), dev)
                for k, t in (("z", z), ("y", y), ("hs", hs)))
    if x_t is None:
        outs = (x, z, y)
        ptrs = (None, None, None)
    else:
        x_t = _check("x_t", x_t, (B, 12 * H), dev)
        outs = (torch.empty_like(x), torch.empty_like(z),
                torch.empty_like(y))
        ptrs = tuple(t.data_ptr() for t in outs)
    r = torch.empty_like(x)
    err = _lib().admm_step_launch(
        None if x_t is None else x_t.data_ptr(), x.data_ptr(), z.data_ptr(),
        y.data_ptr(), Gb.data_ptr(), hs.data_ptr(), qs.data_ptr(), *ptrs,
        r.data_ptr(), B, H, rho, sigma, alpha,
        1.0 - alpha, neg, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "admm_step")
    cuda_build.LAUNCHES["admm_step"] += 1
    return (*outs, r)

