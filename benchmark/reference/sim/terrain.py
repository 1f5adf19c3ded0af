"""Height-map terrain (`legged_mpc_control_tpu/sim/terrain.py`): the ground
model the simulator stands on, the Raibert footholds snap to, and the
contact-implicit MPC's gap function reads.

A `Terrain` is a regular grid of heights with bilinear interpolation, shared
by every scenario of a batch. A `Wall` is a vertical half-space obstacle:
the articulated twin's wall contact (`sim/wb_sim.py`) and the
contact-implicit MPC's wall branch (`mpc/ci_mpc.env_gap_normal`, the lean
policy) read it.
"""

from dataclasses import dataclass

import torch

from benchmark.reference.tree import Struct


@dataclass
class Terrain(Struct):
    heights: torch.Tensor     # (Nx, Ny) grid of ground heights
    origin: torch.Tensor      # (2,) world xy of grid node [0, 0]
    cell: torch.Tensor        # scalar grid spacing (m)


@dataclass
class Wall(Struct):
    """Free space is {p : (p - point) . normal >= 0}; `normal` is the unit
    contact normal pointing out of the wall."""
    point: torch.Tensor       # (3,) any point on the wall plane
    normal: torch.Tensor      # (3,) unit normal into free space


def wall_gap(w: Wall, p):
    """Signed distance of points p (..., 3) to the wall (>= 0 in free
    space)."""
    return ((p - w.point) * w.normal).sum(-1)


def _cell(t: Terrain, xy):
    """Clamped grid coordinates of xy (..., 2): the raw fractional
    coordinates g, the cell's integer corner and the in-cell fractions,
    and the four corner heights."""
    nx, ny = t.heights.shape
    g = (xy - t.origin) / t.cell
    gx = torch.clamp(g[..., 0], 0.0, nx - 1.000001)
    gy = torch.clamp(g[..., 1], 0.0, ny - 1.000001)
    ix = torch.floor(gx).long()
    iy = torch.floor(gy).long()
    fx = gx - ix.to(gx.dtype)
    fy = gy - iy.to(gy.dtype)
    ix1 = torch.clamp(ix + 1, max=nx - 1)
    iy1 = torch.clamp(iy + 1, max=ny - 1)
    h = t.heights
    return g, fx, fy, h[ix, iy], h[ix1, iy], h[ix, iy1], h[ix1, iy1]


def height_at(t: Terrain, xy):
    """Bilinearly-interpolated ground height at world xy (..., 2) ->
    (...). Out-of-grid queries clamp to the edge."""
    _, fx, fy, h00, h10, h01, h11 = _cell(t, xy)
    return ((1 - fx) * (1 - fy) * h00 + fx * (1 - fy) * h10
            + (1 - fx) * fy * h01 + fx * fy * h11)


def height_grad_at(t: Terrain, xy):
    """Analytic gradient of `height_at` w.r.t. world xy: (..., 2). At cell
    boundaries the right-sided subgradient; zero out of the grid."""
    nx, ny = t.heights.shape
    g, fx, fy, h00, h10, h01, h11 = _cell(t, xy)
    dhx = ((1 - fy) * (h10 - h00) + fy * (h11 - h01)) / t.cell
    dhy = ((1 - fx) * (h01 - h00) + fx * (h11 - h10)) / t.cell
    in_x = (g[..., 0] > 0.0) & (g[..., 0] < nx - 1.000001)
    in_y = (g[..., 1] > 0.0) & (g[..., 1] < ny - 1.000001)
    return torch.stack([torch.where(in_x, dhx, torch.zeros_like(dhx)),
                        torch.where(in_y, dhy, torch.zeros_like(dhy))], -1)
