"""Moving-window and causal Savitzky-Golay filters
(`legged_mpc_control_tpu/ops/filters.py`).

The reference's MovingWindowFilter (include/utils/MovingWindowFilter.hpp)
and the smoothing its EKF submodule takes from gram_savitzky_golay
(legged_ctrl CMakeLists.txt:124-136), each as a ring buffer per scenario:
`buf` (B, window) + value_shape, `idx`/`count` (B,).
"""

from dataclasses import dataclass

import torch

from benchmark.reference.config import resolve_device
from benchmark.reference.tree import Struct


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


# the causal SG filter keeps the moving window's ring buffer
SavgolState = MovingWindowState
