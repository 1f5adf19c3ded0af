"""Moving-window filter (`legged_mpc_control_tpu/ops/filters.py`).

The reference's MovingWindowFilter (include/utils/MovingWindowFilter.hpp)
as a ring buffer per scenario: `buf` (B, window), `idx`/`count` (B,).
"""

from dataclasses import dataclass

import torch

from legged_mpc_control_tpu_torch.tree import Struct


@dataclass
class MovingWindowState(Struct):
    buf: torch.Tensor       # (B, window)
    idx: torch.Tensor       # (B,) int32, next write position
    count: torch.Tensor     # (B,) int32, number of valid samples


def moving_window_init(window: int, batch: int, dtype=torch.float32,
                       device=None) -> MovingWindowState:
    return MovingWindowState(
        buf=torch.zeros((batch, window), dtype=dtype, device=device),
        idx=torch.zeros((batch,), dtype=torch.int32, device=device),
        count=torch.zeros((batch,), dtype=torch.int32, device=device))


def moving_window_update(state: MovingWindowState, value):
    """Push `value` (B,); returns (new state, mean of the valid samples)."""
    window = state.buf.shape[1]
    rows = torch.arange(state.buf.shape[0], device=state.buf.device)
    buf = state.buf.clone()
    buf[rows, state.idx.long()] = value
    count = torch.clamp(state.count + 1, max=window)
    idx = (state.idx + 1) % window
    avg = buf.sum(dim=1) / count.to(buf.dtype)
    return MovingWindowState(buf=buf, idx=idx, count=count), avg
