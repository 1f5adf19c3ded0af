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

from legged_mpc_control_tpu_torch.config import resolve_device
from legged_mpc_control_tpu_torch.tree import Struct, from_numpy


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


def wall_at_x(x, dtype=torch.float32, device="cuda") -> Wall:
    """Wall plane x = `x` with free space on the -x side."""
    device = resolve_device(device)
    return Wall(point=torch.tensor([x, 0.0, 0.0], dtype=dtype, device=device),
                normal=torch.tensor([-1.0, 0.0, 0.0], dtype=dtype,
                                    device=device))


def wall_gap(w: Wall, p):
    """Signed distance of points p (..., 3) to the wall (>= 0 in free
    space)."""
    return ((p - w.point) * w.normal).sum(-1)


def flat(extent=4.0, cell=0.1, dtype=torch.float32, device="cuda") -> Terrain:
    device = resolve_device(device)
    n = int(2 * extent / cell) + 1
    return Terrain(
        heights=torch.zeros((n, n), dtype=dtype, device=device),
        origin=torch.tensor([-extent, -extent], dtype=dtype, device=device),
        cell=torch.tensor(cell, dtype=dtype, device=device))


def _grid_xy(t: Terrain):
    nx, ny = t.heights.shape
    dtype, dev = t.heights.dtype, t.heights.device
    xs = t.origin[0] + t.cell * torch.arange(nx, dtype=dtype, device=dev)
    ys = t.origin[1] + t.cell * torch.arange(ny, dtype=dtype, device=dev)
    return xs, ys


def add_box(t: Terrain, center_xy, size_xy, height) -> Terrain:
    """Raise a rectangular box/platform out of the ground."""
    xs, ys = _grid_xy(t)
    inx = (xs - center_xy[0]).abs() <= size_xy[0] / 2.0
    iny = (ys - center_xy[1]).abs() <= size_xy[1] / 2.0
    mask = inx[:, None] & iny[None, :]
    return t.replace(heights=torch.where(
        mask, torch.clamp(t.heights, min=height), t.heights))


def stairs(n_steps=5, step_height=0.05, step_depth=0.25, start_x=0.3,
           extent=4.0, cell=0.05, dtype=torch.float32,
           device="cuda") -> Terrain:
    """Ascending staircase along +x."""
    t = flat(extent=extent, cell=cell, dtype=dtype, device=device)
    nx, ny = t.heights.shape
    xs, _ = _grid_xy(t)
    step_idx = torch.clamp(torch.floor((xs - start_x) / step_depth) + 1.0,
                           0.0, float(n_steps))
    h = (step_idx * step_height)[:, None]
    return t.replace(heights=h.expand(nx, ny).to(dtype).clone())


def random_rough(generator: torch.Generator, amplitude=0.03, extent=4.0,
                 cell=0.1, dtype=torch.float32) -> Terrain:
    """Uniform random rough field (domain-randomization terrain), drawn
    by `generator` on its device."""
    t = flat(extent=extent, cell=cell, dtype=dtype, device=generator.device)
    h = torch.rand(t.heights.shape, generator=generator, dtype=dtype,
                   device=generator.device) * amplitude
    return t.replace(heights=h)


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


def slope_pitch_at(t: Terrain, xy, heading_xy):
    """Terrain pitch (rad) along a heading direction (..., 2)."""
    norm = torch.linalg.vector_norm(heading_xy, dim=-1, keepdim=True)
    d = heading_xy / torch.clamp(norm, min=1e-6)
    step = t.cell
    h0 = height_at(t, xy - 0.5 * step * d)
    h1 = height_at(t, xy + 0.5 * step * d)
    return torch.atan2(h1 - h0, step)


def is_flat_zero(t: Terrain) -> bool:
    """The height field is identically zero (the fused CI kernel's
    gap = foot_z specialization). The answer is read back to the host once
    and kept on the terrain until its heights change, so a solve that asks
    every tick does not wait for the card every tick."""
    key = (id(t.heights), t.heights._version)
    cached = getattr(t, "_flat_zero", None)
    if cached is None or cached[0] != key:
        cached = (key, bool((t.heights == 0).all()))
        t._flat_zero = cached
    return cached[1]


def terrain_from_numpy(tree, device=None, dtype=None) -> Terrain:
    """`Terrain` from an object or dict with numpy-convertible `heights`,
    `origin` and `cell` (a JAX Terrain through `np.asarray`)."""
    out = from_numpy(Terrain, tree, device)
    if dtype is not None:
        out = Terrain(**{k: v.to(dtype) for k, v in vars(out).items()})
    return out


def wall_from_numpy(tree, device=None) -> Wall:
    return from_numpy(Wall, tree, device)
