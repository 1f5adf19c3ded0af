"""Friction-pyramid constraint operators (`legged_mpc_control_tpu/mpc/
pdip.py`): the part the Riccati solver uses. The condensed PDIP solver
itself comes with a later slice.

Constraint rows per (step k, leg l) on the forces u = (fx, fy, fz)
(reference: ConvexQPSolver.cpp:130-177):
    -fx - mu fz <= 0,  fx - mu fz <= 0,  -fy - mu fz <= 0,  fy - mu fz <= 0,
     fz <= fz_max,    -fz <= 0
i.e. G(mu) = GA + mu GB per leg.
"""

from typing import NamedTuple

import torch

N_CON_PER_LEG = 6

_GA = ((-1.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, -1.0, 0.0),
       (0.0, 1.0, 0.0), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))
_GB = ((0.0, 0.0, -1.0),) * 4 + ((0.0, 0.0, 0.0),) * 2


class PdipResult(NamedTuple):
    u: torch.Tensor         # (B, 12H) optimal GRFs over the horizon
    gap: torch.Tensor       # (B,) final mean complementarity
    r_dual: torch.Tensor    # (B,) final dual residual inf-norm (-1: skipped)
    iters: int              # iterations run


def _bmu(mu, out_ndim, like):
    """Scalar or (B,) mu shaped to broadcast against an out_ndim tensor."""
    mu = torch.as_tensor(mu, dtype=like.dtype, device=like.device)
    return mu.reshape(mu.shape + (1,) * (out_ndim - mu.dim()))


def _g(like):
    return (torch.tensor(_GA, dtype=like.dtype, device=like.device),
            torch.tensor(_GB, dtype=like.dtype, device=like.device))


def _g_apply(u_legs, mu):
    """G u: u_legs (..., H, 4, 3) -> (..., H, 4, 6); mu scalar or (B,)."""
    GA, GB = _g(u_legs)
    a = u_legs @ GA.T
    b = u_legs @ GB.T
    return a + _bmu(mu, a.dim(), a) * b


def _gt_apply(w, mu):
    """G^T w: w (..., H, 4, 6) -> (..., H, 4, 3)."""
    GA, GB = _g(w)
    a = w @ GA
    b = w @ GB
    return a + _bmu(mu, a.dim(), a) * b


def _gtdg_blocks(d, mu):
    """3x3 blocks of G^T diag(d) G: d (..., H, 4, 6) -> (..., H, 4, 3, 3)."""
    GA, GB = _g(d)
    aa = torch.einsum("...r,ri,rj->...ij", d, GA, GA)
    ab = torch.einsum("...r,ri,rj->...ij", d, GA, GB)
    bb = torch.einsum("...r,ri,rj->...ij", d, GB, GB)
    m = _bmu(mu, aa.dim(), aa)
    return aa + m * (ab + ab.transpose(-1, -2)) + m * m * bb


def _h_vec(H, fz_max, like):
    """RHS h of G u <= h: fz_max.shape + (H, 4, 6), fz_max on the cap row."""
    fz = torch.as_tensor(fz_max, dtype=like.dtype, device=like.device)
    e_cap = torch.zeros((6,), dtype=like.dtype, device=like.device)
    e_cap[4] = 1.0
    return fz[..., None, None, None] * e_cap.expand(H, 4, 6)
