"""Kernel K7 wrapper: every contact-implicit GN-iLQR sweep in one launch
(csrc/ci_sweeps.cu), the port of the TPU kernel
`legged_mpc_control_tpu/ops/ci_pallas.py:ci_sweeps_fused`, for flat-zero
terrain and no wall (`mpc/ci_mpc.ci_pallas_available`).

`ci_sweeps_cuda` launches the kernel on CUDA tensors (float32 only) and runs
the plain version `ci_sweeps_plain` on CPU tensors. The plain version is the
dense sweep loop of `mpc/ci_mpc.py` with the kernel's line-search rule: a
scenario whose five candidates all cost a non-finite amount keeps its
nominal (the JAX "xla" backend commits alpha = 1 there; ROADMAP "Faults
found").

Arguments, batch-first as the JAX function takes them: z0 (B,24), Uh0
(B,H,24) scaled inputs (forces in units of s_f N), ref_zu (B,H,48) scaled
stage references, refT (B,24), f_mask (B,H,4), rho0 (B,), wts_vec (52,) =
[c_fb, c_slip, c_cone, c_mask] + the 48-dim tracking diagonal 2 q, mu and
mass scalars, Iw_inv (B,3,3). Returns (Uh (B,H,24) scaled, Z (B,H+1,24),
cost (B,)).

The kernel keeps a scenario's whole problem in its block's shared memory,
so it serves 1 <= H <= `max_horizon()` (54 on an H100); the dispatch
(`mpc/ci_mpc.ci_pallas_available`) sends it H <= 12. It has two variants
that share one shared-memory layout, compute the same numbers bit for bit
and map a scenario onto the SM differently (csrc/ci_sweeps.cu): the
latency variant, a block of six warps a scenario, two an SM at H=10; and
the batch variant, three warps a scenario, four an SM. `ci_sweeps_cuda`
launches the batch variant only where the batch is past the latency
variant's one wave (its resident blocks an SM times the SMs) and the batch
variant holds more scenarios an SM at that H (`residency`);
`cuda_build.LAUNCHES` counts every launch under "ci_sweeps" and the batch
variant's also under "ci_sweeps_batch".
"""

import ctypes
import functools

import torch

from legged_mpc_control_tpu_torch.ops import cuda_build
from legged_mpc_control_tpu_torch.utils import trace

NZ = 24
NW = 52


def ci_sweeps_plain(z0, Uh0, ref_zu, refT, f_mask, rho0, wts_vec, mu, mass,
                    Iw_inv, *, iters, dt, s_f, rho_min, reg, state_reg):
    """Plain version of K7 (any dtype, any device)."""
    from legged_mpc_control_tpu_torch.mpc import ci_mpc

    dtype, dev = z0.dtype, z0.device
    return ci_mpc._sweeps(
        z0, Uh0, ref_zu, refT, f_mask,
        torch.as_tensor(rho0, dtype=dtype, device=dev).expand(z0.shape[0]),
        wts_vec, torch.as_tensor(mu, dtype=dtype, device=dev),
        torch.as_tensor(mass, dtype=dtype, device=dev), Iw_inv, None,
        iters=iters, dt=dt, s_f=s_f, rho_min=rho_min, reg=reg,
        state_reg=state_reg,
        solve=functools.partial(ci_mpc._psd_solve_b, backend="plain"),
        keep_nominal=True)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("ci_sweeps")
    for entry in (lib.ci_sweeps_launch, lib.ci_sweeps_batch_launch):
        entry.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                          + [ctypes.c_float] * 5 + [ctypes.c_void_p])
        entry.restype = ctypes.c_int
    lib.ci_sweeps_max_h.restype = ctypes.c_int
    lib.ci_sweeps_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int)]
    lib.ci_sweeps_blocks_per_sm.restype = ctypes.c_int
    return lib


def max_horizon():
    """The largest H kernel K7 serves (its shared memory a block)."""
    return _lib().ci_sweeps_max_h()


@functools.lru_cache(maxsize=None)
def residency(index, H):
    """(latency variant's, batch variant's) resident blocks (scenarios) an
    SM at horizon H on CUDA device `index`, and the device's SMs: the
    occupancy API's readings, once per (device, H)."""
    lib = _lib()
    blocks = ctypes.c_int()
    per_sm = []
    with torch.cuda.device(index):
        for batch in (0, 1):
            cuda_build.check(lib.ci_sweeps_blocks_per_sm(
                H, batch, ctypes.byref(blocks)), "ci_sweeps occupancy")
            per_sm.append(blocks.value)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return per_sm[0], per_sm[1], sms


def batch_variant_wins(B, latency_per_sm, batch_per_sm, sms):
    """Whether a launch of B scenarios takes the batch variant: B is past
    the latency variant's one wave and the batch variant holds more
    scenarios an SM."""
    return B > latency_per_sm * sms and batch_per_sm > latency_per_sm


def _prepare(z0, Uh0, ref_zu, refT, f_mask, rho0, wts_vec, mu, mass, Iw_inv,
             *, iters, dt, s_f, rho_min, reg, state_reg):
    """The checked arguments of a launch, as the C entries take them after
    their outputs (module docstring)."""
    B, H = Uh0.shape[0], Uh0.shape[1]
    dev = z0.device
    rho0 = torch.as_tensor(rho0, dtype=z0.dtype, device=dev).expand(B)
    mu = torch.as_tensor(mu, dtype=z0.dtype, device=dev).reshape(1)
    mass = torch.as_tensor(mass, dtype=z0.dtype, device=dev).reshape(1)
    args = {"z0": (z0, (B, NZ)), "Uh0": (Uh0, (B, H, NZ)),
            "ref_zu": (ref_zu, (B, H, 2 * NZ)), "refT": (refT, (B, NZ)),
            "f_mask": (f_mask, (B, H, 4)), "rho0": (rho0, (B,)),
            "wts_vec": (wts_vec, (NW,)), "mu": (mu, (1,)),
            "mass": (mass, (1,)), "Iw_inv": (Iw_inv, (B, 3, 3))}
    for name, (t, shape) in args.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: kernel K7 takes float32 only, got "
                            f"{t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, want {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    if dev.type != "cuda":
        raise ValueError(f"z0: tensor on {dev}, want cuda (or cpu for the "
                         "plain version)")
    if not 1 <= H <= max_horizon():
        raise ValueError(f"Uh0: horizon {H}; kernel K7 serves 1 <= H <= "
                         f"{max_horizon()} (its shared memory a block)")
    z0, Uh0, ref_zu, refT, f_mask, rho0, Iw_inv = (
        t.contiguous() for t in (z0, Uh0, ref_zu, refT, f_mask, rho0,
                                 Iw_inv))
    misc = torch.cat([wts_vec, mu, mass])
    return ((z0, Uh0, ref_zu, refT, f_mask, rho0, Iw_inv, misc),
            (B, H, int(iters)),
            (float(dt), float(s_f), float(rho_min), float(reg),
             float(state_reg)))


def _run(entry, prepared):
    """Launch the C entry `entry` (either variant's) on `_prepare`'s
    arguments; returns (U, Z, cost)."""
    tensors, ints, floats = prepared
    B, H = ints[:2]
    dev = tensors[0].device
    U = torch.empty((B, H, NZ), dtype=torch.float32, device=dev)
    Z = torch.empty((B, H + 1, NZ), dtype=torch.float32, device=dev)
    cost = torch.empty((B,), dtype=torch.float32, device=dev)
    err = entry(*(t.data_ptr() for t in tensors + (U, Z, cost)), *ints,
                *floats, torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "ci_sweeps")
    return U, Z, cost


@trace.spanned(trace.K7)
def ci_sweeps_cuda(z0, Uh0, ref_zu, refT, f_mask, rho0, wts_vec, mu, mass,
                   Iw_inv, *, iters, dt, s_f, rho_min, reg, state_reg):
    """The sweep loop: kernel K7 on CUDA tensors, the plain version on CPU
    tensors (module docstring)."""
    if z0.device.type == "cpu":
        return ci_sweeps_plain(z0, Uh0, ref_zu, refT, f_mask, rho0, wts_vec,
                               mu, mass, Iw_inv, iters=iters, dt=dt, s_f=s_f,
                               rho_min=rho_min, reg=reg, state_reg=state_reg)
    prepared = _prepare(z0, Uh0, ref_zu, refT, f_mask, rho0, wts_vec, mu,
                        mass, Iw_inv, iters=iters, dt=dt, s_f=s_f,
                        rho_min=rho_min, reg=reg, state_reg=state_reg)
    B, H = prepared[1][:2]
    batch = batch_variant_wins(B, *residency(z0.device.index, H))
    lib = _lib()
    out = _run(lib.ci_sweeps_batch_launch if batch else lib.ci_sweeps_launch,
               prepared)
    cuda_build.LAUNCHES["ci_sweeps"] += 1
    if batch:
        cuda_build.LAUNCHES["ci_sweeps_batch"] += 1
    return out
