"""Moving-window and causal Savitzky-Golay filters
(`legged_mpc_control_tpu/ops/filters.py`).

The reference's MovingWindowFilter (include/utils/MovingWindowFilter.hpp)
and the smoothing its EKF submodule takes from gram_savitzky_golay
(legged_ctrl CMakeLists.txt:124-136), each as a ring buffer per scenario:
`buf` (B, window) + value_shape, `idx`/`count` (B,).
"""

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from legged_mpc_control_tpu_torch.config import resolve_device
from legged_mpc_control_tpu_torch.tree import Struct


@dataclass
class MovingWindowState(Struct):
    buf: torch.Tensor       # (B, window) + value_shape
    idx: torch.Tensor       # (B,) int32, next write position
    count: torch.Tensor     # (B,) int32, number of valid samples


def _ring_init(window, batch, dtype, device, value_shape):
    device = resolve_device(device)
    return dict(
        buf=torch.zeros((batch, window) + tuple(value_shape), dtype=dtype,
                        device=device),
        idx=torch.zeros((batch,), dtype=torch.int32, device=device),
        count=torch.zeros((batch,), dtype=torch.int32, device=device))


def _ring_push(state, value):
    """(buf, idx, count) after writing `value` (B,) + value_shape at each
    scenario's write position."""
    window = state.buf.shape[1]
    rows = torch.arange(state.buf.shape[0], device=state.buf.device)
    buf = state.buf.clone()
    buf[rows, state.idx.long()] = value
    count = torch.clamp(state.count + 1, max=window)
    return buf, (state.idx + 1) % window, count


def _lead(x, like):
    """x (B,) shaped to broadcast over like's trailing axes."""
    return x.reshape(x.shape + (1,) * (like.dim() - 1))


def moving_window_init(window: int, batch: int, dtype=torch.float32,
                       device="cuda", value_shape=()) -> MovingWindowState:
    return MovingWindowState(**_ring_init(window, batch, dtype, device,
                                          value_shape))


def moving_window_update(state: MovingWindowState, value):
    """Push `value` (B,) + value_shape; returns (new state, mean of the
    valid samples)."""
    buf, idx, count = _ring_push(state, value)
    avg = buf.sum(dim=1) / _lead(count.to(buf.dtype), value)
    return MovingWindowState(buf=buf, idx=idx, count=count), avg


def savgol_coeffs(window: int, order: int = 2, deriv: int = 0,
                  dt: float = 1.0):
    """Causal Savitzky-Golay coefficients: fit an `order`-degree polynomial
    to the last `window` samples and evaluate its value (deriv 0) or
    derivative (deriv 1) at the newest sample. (window,) float64 numpy,
    oldest sample first."""
    t = (np.arange(window) - (window - 1)) * dt       # newest sample at 0
    A = np.vander(t, order + 1, increasing=True)      # (W, order+1)
    # the fit's coefficients are (A'A)^-1 A' y; at t = 0 the value and the
    # derivative pick row `deriv` (times deriv!)
    pinv = np.linalg.solve(A.T @ A, A.T)              # (order+1, W)
    return pinv[deriv] * math.factorial(deriv)


@functools.lru_cache(maxsize=None)
def _coeffs(window, order, deriv, dt, dtype, device):
    """savgol_coeffs on `device`, built once: a tensor made from numpy at
    every call is a host-to-device copy that waits for queued work."""
    return torch.as_tensor(savgol_coeffs(window, order, deriv, dt),
                           dtype=dtype, device=device)


# the causal SG filter keeps the moving window's ring buffer
SavgolState = MovingWindowState


def savgol_init(window: int, batch: int, dtype=torch.float32,
                device="cuda", value_shape=()) -> SavgolState:
    return SavgolState(**_ring_init(window, batch, dtype, device,
                                    value_shape))


def savgol_update(state: SavgolState, value, order: int = 2,
                  deriv: int = 0, dt: float = 1.0):
    """Push `value` (B,) + value_shape; returns (new state, the SG-filtered
    output at the newest sample). A scenario whose buffer is not yet full
    passes its raw value through."""
    window = state.buf.shape[1]
    buf, idx, count = _ring_push(state, value)
    coeffs = _coeffs(window, order, deriv, float(dt), buf.dtype, buf.device)
    # oldest first: the sample k ago sits at (idx - 1 - k) mod window
    k = torch.arange(window, device=buf.device)
    order_idx = (idx.long()[:, None] - window + k) % window       # (B, W)
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    seq = buf[rows, order_idx]                        # oldest ... newest
    out = (seq * coeffs.reshape((1, window) + (1,) * (buf.dim() - 2))
           ).sum(dim=1)
    out = torch.where(_lead(count >= window, value), out, value)
    return SavgolState(buf=buf, idx=idx, count=count), out
