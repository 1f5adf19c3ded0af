"""Contact-implicit MPC (`legged_mpc_control_tpu/mpc/ci_mpc.py`): trajectory
optimization through contact, the reference's second MPC backend
(reference: src/legged_ctrl/src/mpc_ctrl/ci_mpc/LciMpc.cpp; capability
claim README.md:14: Go1 trot, box-step and lean against a wall).

Model: single rigid body + 4 velocity-controlled point feet,
    state z in R^24 = [pos(3), eul(3), v(3), omega(3), feet_world(12)]
    input u in R^24 = [grf(12) world, foot_vel(12) world],
with contact through annealed, smoothed complementarity penalties against
the terrain height field (gap = foot_z - height(foot_xy)): a smoothed
Fischer-Burmeister residual on (fz, gap), slip while loaded, a friction
pyramid. With a vertical `Wall` the gap and the contact normal are those of
the whole environment (`env_gap_normal`: ground and wall blended by a
sigmoid), the force splits into its normal and tangential parts against
that normal, and the friction set is the circular cone. The solver is a
batched Gauss-Newton iLQR with analytic dynamics Jacobians, closed-form
per-foot residual Jacobians (the derivatives of `_foot_res`, held to its
`torch.func.jacfwd` by the tests), a Riccati backward pass with Levenberg
state regularization and a batched Cholesky gain solve, and a 5-candidate
line search. Everything is batch-first: z0 (B, NZ), U (B, H, NU).

`ci_solve_batched` runs one of three backends:
  "fused"  the whole sweep loop in one launch of kernel K7
           (`ops/ci_kernel.py`, csrc/ci_sweeps.cu): flat-zero terrain only;
  "lanes"  this module's sweeps with the gain solve on kernels K4 + K6
           (`ops/chol_kernel.py`), any height field, with or without a
           wall;
  "plain"  this module's sweeps with the library Cholesky (the JAX
           package's "xla" backend); for tests and reference runs.
On CPU tensors every backend runs its plain version. The default on the
card is "fused" where `ci_pallas_available` holds, else "lanes".

Policies for the LCI seam (`mpc/lci_mpc.py`): the trot walk
(`make_ci_walk_policy_batched`, and its single-robot view
`make_ci_walk_policy`) and the wall lean of one robot
(`make_ci_lean_policy`, on the articulated twin through
`control/step.closed_loop_tick_lci_wb`).
"""

import functools
import math
from dataclasses import dataclass

import torch

from legged_mpc_control_tpu_torch.control import raibert
from legged_mpc_control_tpu_torch.config import resolve_device
from legged_mpc_control_tpu_torch.ops import chol_kernel, ci_kernel, so3
from legged_mpc_control_tpu_torch.sim import terrain as terrain_mod
from legged_mpc_control_tpu_torch.tree import Struct, from_numpy
from legged_mpc_control_tpu_torch.utils import trace

NZ = 24
NU = 24
GRAV = 9.81
# complementarity scaling: forces in F0 N, gaps in G0 m (O(1) residuals)
F0 = 50.0
G0 = 0.02
ALPHAS = (1.0, 0.5, 0.25, 0.05, 0.0)
MAX_H_FUSED = 12
BACKENDS = ("fused", "lanes", "plain")


@dataclass
class CiWeights(Struct):
    """Cost weights; the complementarity weights are the penalty strengths
    the rho anneal tightens against."""
    q_pos: torch.Tensor      # (3,)
    q_eul: torch.Tensor      # (3,)
    q_vel: torch.Tensor      # (3,)
    q_omega: torch.Tensor    # (3,)
    q_foot: torch.Tensor     # (3,) foot-position template tracking (weak)
    r_f: torch.Tensor        # GRF regularization
    r_w: torch.Tensor        # foot-velocity regularization
    c_fb: torch.Tensor       # Fischer-Burmeister complementarity residual
    c_slip: torch.Tensor     # tangential foot velocity while loaded
    c_cone: torch.Tensor     # friction pyramid
    c_mask: torch.Tensor     # force on mask-forbidden feet


def default_weights(dtype=torch.float32, device="cuda") -> CiWeights:
    device = resolve_device(device)

    def a(v):
        return torch.tensor(v, dtype=dtype, device=device)
    return CiWeights(
        q_pos=a([30.0, 30.0, 120.0]), q_eul=a([60.0, 60.0, 30.0]),
        q_vel=a([20.0, 20.0, 30.0]), q_omega=a([1.0, 1.0, 1.0]),
        q_foot=a([18.0, 18.0, 60.0]), r_f=a(1e-3), r_w=a(5e-2),
        c_fb=a(40.0), c_slip=a(8.0), c_cone=a(10.0), c_mask=a(60.0))


@functools.lru_cache(maxsize=None)
def _cached_weights(dtype, device):
    return default_weights(dtype, device)


def weights_from_numpy(tree, device=None, dtype=None) -> CiWeights:
    """`CiWeights` from an object or dict of arrays keyed by field name
    (a JAX CiWeights through `np.asarray`)."""
    w = from_numpy(CiWeights, tree, device)
    if dtype is not None:
        w = CiWeights(**{k: v.to(dtype) for k, v in vars(w).items()})
    return w


@functools.lru_cache(maxsize=None)
def _const(values, dtype, device):
    """A constant tensor, made once per dtype and device (a tensor built
    from a list at every call is a host-to-device copy)."""
    return torch.tensor(values, dtype=dtype, device=device)


def _height(terrain, xy):
    """Ground height under xy (..., 2); terrain None is flat ground at 0."""
    if terrain is None:
        return torch.zeros_like(xy[..., 0])
    return terrain_mod.height_at(terrain, xy)


def _height_grad(terrain, xy):
    if terrain is None:
        return torch.zeros_like(xy)
    return terrain_mod.height_grad_at(terrain, xy)


def _softplus(x):
    """max(x, 0) + log1p(exp(-|x|)), as jax.nn.softplus and kernel K7."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _sp(x, rho):
    """Smoothed relu: rho * softplus(x / rho) -> max(x, 0) as rho -> 0."""
    return rho * _softplus(x / rho)


def _fb(a, b, rho):
    """Smoothed Fischer-Burmeister: zero iff a >= 0, b >= 0 and a*b ~
    rho^2/2; negative when either is negative."""
    return a + b - torch.sqrt(a * a + b * b + rho * rho)


def _sp_ad(x, rho):
    """`_sp` through `torch.logaddexp` (jax.nn.softplus's own form): the
    same values, with the sigmoid as its derivative under forward-mode
    autodiff everywhere (`_softplus`'s clamp and abs give 1 at x = 0)."""
    return rho * torch.logaddexp(x / rho, torch.zeros_like(x))


def env_gap_normal(terrain, wall, p, beta=0.03):
    """Smooth gap and contact normal of the whole environment, the ground
    height field (None: flat ground at 0) plus an optional vertical `Wall`,
    at points p (..., 3). The two half-space gaps are blended by a sigmoid
    softmin of width `beta`, so gap and normal are smooth in p, the
    ground/wall corner included: near the wall the normal turns from +z to
    the wall's, and the closer surface owns the contact. Returns (gap (...),
    n (..., 3))."""
    return _blend(p[..., 2] - _height(terrain, p[..., 0:2]), wall, p, beta)


def _blend(gap_g, wall, p, beta=0.03):
    """`env_gap_normal` from the ground gap gap_g (...) of the points p."""
    up = _const((0.0, 0.0, 1.0), p.dtype, p.device)
    if wall is None:
        return gap_g, up.expand(p.shape)
    gap_w = terrain_mod.wall_gap(wall, p)
    w_wall = torch.sigmoid((gap_g - gap_w) / beta)      # ~1 where the wall
    gap = w_wall * gap_w + (1.0 - w_wall) * gap_g       # is closer
    n = (w_wall[..., None] * wall.normal.to(p.dtype)
         + (1.0 - w_wall[..., None]) * up)
    n = n / torch.sqrt((n * n).sum(-1, keepdim=True) + 1e-12)
    return gap, n


def _wall_comp(f, w, feet, terrain, wall, mu, rho, c_fb, c_slip, c_cone):
    """The wall branch's complementarity cost per foot, f and w (..., 4, 3)
    unscaled, rho broadcast against (..., 4): the force split into normal
    and tangential parts against the blended normal, the circular friction
    cone on |f_t| (per-axis pyramid bounds mean nothing against a rotated
    normal; the cone is the pyramid's inscribed set). Returns (comp (...,
    4), a = f_n / F0)."""
    gap, n = env_gap_normal(terrain, wall, feet)
    fn = (f * n).sum(-1)
    ft = f - fn[..., None] * n
    wt = w - (w * n).sum(-1, keepdim=True) * n
    a = fn / F0
    b = gap / G0
    ft_mag = torch.sqrt((ft * ft).sum(-1) + 1e-8)
    return (c_fb * _fb(a, b, rho) ** 2
            + c_slip * _sp(a, rho) * (wt * wt).sum(-1)
            + c_cone * _sp((ft_mag - mu * fn) / F0, rho) ** 2), a


def _dyn_b(z, uh, mass, Iw_inv, dt, s_f=1.0):
    """Smooth SRB+feet step. z (..., NZ), uh (..., NU) with the force
    channels in units of `s_f` N, Iw_inv (..., 3, 3) world-frame inverse
    trunk inertia (broadcast against z's leading dims)."""
    lead = z.shape[:-1]
    pos, v, om = z[..., 0:3], z[..., 6:9], z[..., 9:12]
    feet = z[..., 12:24].reshape(lead + (4, 3))
    f = s_f * uh[..., 0:12].reshape(lead + (4, 3))
    w = uh[..., 12:24].reshape(lead + (4, 3))
    acc = f.sum(-2) / mass + _const((0.0, 0.0, -GRAV), z.dtype, z.device)
    tau = torch.linalg.cross(feet - pos[..., None, :], f).sum(-2)
    return torch.cat([
        pos + dt * v,
        z[..., 3:6] + dt * om,
        v + dt * acc,
        om + dt * (Iw_inv @ tau[..., None])[..., 0],
        (feet + dt * w).reshape(lead + (12,))], -1)


def ci_dynamics(z, u, mass, inertia_w_inv, dt):
    """One smooth SRB+feet step in unscaled inputs (any leading dims)."""
    return _dyn_b(z, u, mass, inertia_w_inv, dt)


def _rollout_b(z0, U, mass, Iw_inv, dt, s_f=1.0):
    """z0 (B, NZ), U (B, H, NU) -> Z (B, H+1, NZ)."""
    Z = [z0]
    for k in range(U.shape[1]):
        Z.append(_dyn_b(Z[-1], U[:, k], mass, Iw_inv, dt, s_f))
    return torch.stack(Z, 1)


def ci_stage_cost(z, u, ref_z, ref_u, terrain, wts: CiWeights, mu, rho,
                  f_mask=None, wall=None):
    """Tracking + relaxed complementarity of stage states z (..., NZ) and
    unscaled inputs u (..., NU); rho broadcasts against the leading dims.
    With a `wall` the complementarity is `_wall_comp`'s. f_mask (..., 4):
    feet with mask 0 pay for normal force at this stage. Returns (...)."""
    lead = z.shape[:-1]
    pos, eul, v, om = z[..., 0:3], z[..., 3:6], z[..., 6:9], z[..., 9:12]
    feet = z[..., 12:24].reshape(lead + (4, 3))
    f = u[..., 0:12].reshape(lead + (4, 3))
    w = u[..., 12:24].reshape(lead + (4, 3))
    fz = f[..., 2]
    rho = torch.as_tensor(rho, dtype=z.dtype, device=z.device)[..., None]
    track = ((wts.q_pos * (pos - ref_z[..., 0:3]) ** 2).sum(-1)
             + (wts.q_eul * (eul - ref_z[..., 3:6]) ** 2).sum(-1)
             + (wts.q_vel * (v - ref_z[..., 6:9]) ** 2).sum(-1)
             + (wts.q_omega * (om - ref_z[..., 9:12]) ** 2).sum(-1)
             + (wts.q_foot * (feet - ref_z[..., 12:24].reshape(
                 lead + (4, 3))) ** 2).sum((-1, -2))
             + wts.r_f * ((u[..., 0:12] - ref_u[..., 0:12]) ** 2).sum(-1)
             + wts.r_w * ((u[..., 12:24] - ref_u[..., 12:24]) ** 2).sum(-1))
    if wall is None:
        gap = feet[..., 2] - _height(terrain, feet[..., 0:2])
        a = fz / F0
        b = gap / G0
        comp = (wts.c_fb * (_fb(a, b, rho) ** 2).sum(-1)
                + wts.c_slip * (_sp(a, rho)[..., None]
                                * w[..., 0:2] ** 2).sum((-1, -2))
                + wts.c_cone * (_sp((f[..., 0].abs() - mu * fz) / F0, rho)
                                ** 2
                                + _sp((f[..., 1].abs() - mu * fz) / F0, rho)
                                ** 2).sum(-1))
    else:
        comp, a = _wall_comp(f, w, feet, terrain, wall, mu, rho, wts.c_fb,
                             wts.c_slip, wts.c_cone)
        comp = comp.sum(-1)
    if f_mask is not None:
        comp = comp + wts.c_mask * (((1.0 - f_mask) * a) ** 2).sum(-1)
    return track + comp


def _traj_cost_b(Z, U, refs_z, refs_u, terrain, wts, mu, rho, f_mask,
                 wall=None):
    """Exact total cost of a rolled-out trajectory. Z (B,H+1,NZ), U
    unscaled (B,H,NU), rho (B,). Returns (B,)."""
    stage = ci_stage_cost(Z[:, :-1], U, refs_z[:, :-1], refs_u, terrain,
                          wts, mu, rho[:, None], f_mask, wall)
    zT, rT = Z[:, -1], refs_z[:, -1]
    term = ((wts.q_pos * (zT[:, 0:3] - rT[:, 0:3]) ** 2).sum(-1)
            + (wts.q_eul * (zT[:, 3:6] - rT[:, 3:6]) ** 2).sum(-1)
            + (wts.q_vel * (zT[:, 6:9] - rT[:, 6:9]) ** 2).sum(-1))
    return stage.sum(1) + term


def _total_cost_b(z0, U, refs_z, refs_u, terrain, wts, mu, rho, mass,
                  Iw_inv, dt, f_mask, wall=None):
    """Exact total cost from z0 under unscaled U. Returns ((B,), Z)."""
    Z = _rollout_b(z0, U, mass, Iw_inv, dt)
    return _traj_cost_b(Z, U, refs_z, refs_u, terrain, wts, mu, rho,
                        f_mask, wall), Z


def _dyn_jac_b(Zs, Uh, mass, Iw_inv, dt, s_f):
    """Analytic per-stage Jacobians of `_dyn_b` in scaled input coords.
    Zs (B,H,NZ), Uh (B,H,NU) -> Fz (B,H,NZ,NZ), Fu (B,H,NZ,NU).

      pos<-v, eul<-om, feet<-w : dt*I          (constant)
      v<-f                     : dt*s_f/m * I  (constant)
      om<-pos    : +dt*Iw_inv @ sum_i skew(f_i)
      om<-feet_i : -dt*Iw_inv @ skew(f_i)
      om<-f_i    : +dt*s_f*Iw_inv @ skew(feet_i - pos)
    """
    B, H = Zs.shape[0], Zs.shape[1]
    dtype, dev = Zs.dtype, Zs.device
    f = s_f * Uh[..., 0:12].reshape(B, H, 4, 3)
    r = Zs[..., 12:24].reshape(B, H, 4, 3) - Zs[..., None, 0:3]
    sk_f = so3.skew(f)                                      # (B,H,4,3,3)
    Iw = Iw_inv[:, None]                                    # (B,1,3,3)
    P = dt * (Iw @ sk_f.sum(2))
    G = -dt * (Iw[:, :, None] @ sk_f)
    Rm = (dt * s_f) * (Iw[:, :, None] @ so3.skew(r))
    eye = torch.eye(NZ, dtype=dtype, device=dev)
    Fz = eye.expand(B, H, NZ, NZ).clone()
    i3 = torch.arange(3, device=dev)
    Fz[..., i3, 6 + i3] = dt
    Fz[..., 3 + i3, 9 + i3] = dt
    Fz[..., 9:12, 0:3] = P
    Fz[..., 9:12, 12:24] = G.transpose(2, 3).reshape(B, H, 3, 12)
    Fu = torch.zeros((B, H, NZ, NU), dtype=dtype, device=dev)
    i12 = torch.arange(12, device=dev)
    Fu[..., 12 + i12, 12 + i12] = dt
    vf = (dt * s_f) / mass
    for leg in range(4):
        Fu[..., 6 + i3, 3 * leg + i3] = vf
    Fu[..., 9:12, 0:12] = Rm.transpose(2, 3).reshape(B, H, 3, 12)
    return Fz, Fu


def _flat_res_jac(feet, fh, wh, fm, rho, terrain, mu, s_f):
    """Closed-form per-foot residuals r (..., 8) and Jacobian J (..., 8, 9)
    w.r.t. zeta = [foot_pos(3), f_hat(3), w(3)]; rows [fb, slip_x, slip_y,
    cone_x, cone_y, mask, a, b] (the last two carry the scaled normal force
    and gap, weight 0, for the FB curvature restoration). rho broadcasts
    against feet's leading dims."""
    f = s_f * fh
    a = f[..., 2] / F0
    h = _height(terrain, feet[..., 0:2])
    hg = _height_grad(terrain, feet[..., 0:2])
    b = (feet[..., 2] - h) / G0
    s = torch.sqrt(a * a + b * b + rho * rho)
    spa = _sp(a, rho)
    sig = _sigmoid(a / rho)                                 # sp'(a; rho)
    sq = torch.sqrt(spa + 1e-12)
    dsq = sig / (2.0 * sq)
    sfF0 = s_f / F0
    dbx = -hg[..., 0] / G0
    dby = -hg[..., 1] / G0
    dbz = torch.full_like(b, 1.0 / G0)
    z = torch.zeros_like(a)
    ca = 1.0 - a / s
    cb = 1.0 - b / s
    t4 = (f[..., 0].abs() - mu * f[..., 2]) / F0
    t5 = (f[..., 1].abs() - mu * f[..., 2]) / F0
    sig4 = _sigmoid(t4 / rho)
    sig5 = _sigmoid(t5 / rho)
    sgn0 = torch.sign(f[..., 0])
    sgn1 = torch.sign(f[..., 1])
    r = torch.stack([a + b - s, sq * wh[..., 0], sq * wh[..., 1],
                     _sp(t4, rho), _sp(t5, rho), (1.0 - fm) * a, a, b], -1)

    def row(**cols):
        return torch.stack([cols.get(f"c{i}", z) for i in range(9)], -1)
    J = torch.stack([
        row(c0=cb * dbx, c1=cb * dby, c2=cb * dbz, c5=ca * sfF0),
        row(c5=dsq * wh[..., 0] * sfF0, c6=sq),
        row(c5=dsq * wh[..., 1] * sfF0, c7=sq),
        row(c3=sig4 * sgn0 * sfF0, c5=-sig4 * mu * sfF0),
        row(c4=sig5 * sgn1 * sfF0, c5=-sig5 * mu * sfF0),
        row(c5=(1.0 - fm) * sfF0),
        row(c5=torch.full_like(a, sfF0)),
        row(c0=dbx, c1=dby, c2=dbz)], -2)
    return r, J


def _foot_res(zeta, fm, rho, terrain, wall, mu, s_f, ground=None):
    """Per-foot complementarity residual r (8,) of one foot's variables
    zeta = [foot_pos(3), f_hat(3), w(3)] (force in units of s_f N); fm, rho
    0-dim. The stage cost's complementarity part is exactly sum_i W_i
    r_i^2 with `_res_weights`. The last two rows carry the scaled
    normal force a and gap b (weight 0): its Jacobian also gives grad a
    and grad b, the directions of the Fischer-Burmeister curvature
    restoration. The quadratization uses closed forms of that Jacobian
    (`_flat_res_jac`, `_wall_res_jac`); this function defines them, and
    the tests take its `torch.func.jacfwd` under vmap to hold them. It is
    written on one-element slices: under those transforms a 0-dim tensor
    times a Python float comes out float64.

    ground: (h, grad h, xy) of the height field at this foot, evaluated
    outside the vmap (a grid lookup indexes by data, which vmap refuses);
    the height is then h + grad h . (p_xy - xy), the same value at p and
    the same derivative as the bilinear lookup's."""
    p, f, wh = zeta[0:3], s_f * zeta[3:6], zeta[6:9]
    fm, rho = fm.reshape(1), rho.reshape(1)
    if ground is None:
        gap_g = p[2:3] - _height(terrain, p[None, 0:2])
    else:
        h, hg, xy = ground
        gap_g = p[2:3] - (h + (hg * (p[0:2] - xy)).sum(-1, keepdim=True))
    if wall is None:
        a = f[2:3] / F0
        b = gap_g / G0
        sq = torch.sqrt(_sp_ad(a, rho) + 1e-12)
        return torch.cat([
            _fb(a, b, rho), sq * wh[0:1], sq * wh[1:2],
            _sp_ad((f[0:1].abs() - mu * f[2:3]) / F0, rho),
            _sp_ad((f[1:2].abs() - mu * f[2:3]) / F0, rho),
            (1.0 - fm) * a, a, b])
    gap, n = _blend(gap_g, wall, p[None])
    n = n[0]
    fn = (f * n).sum(-1, keepdim=True)
    ft = f - fn * n
    wt = wh - (wh * n).sum(-1, keepdim=True) * n
    a = fn / F0
    b = gap / G0
    ft_mag = torch.sqrt((ft * ft).sum(-1, keepdim=True) + 1e-8)
    sq = torch.sqrt(_sp_ad(a, rho) + 1e-12)
    return torch.cat([
        _fb(a, b, rho), sq * wt,
        _sp_ad((ft_mag - mu * fn) / F0, rho), (1.0 - fm) * a, a, b])


def _res_weights(c_fb, c_slip, c_cone, c_mask, wall):
    """The weights of `_foot_res`'s eight rows."""
    zero = torch.zeros_like(c_fb)
    if wall is None:
        rows = (c_fb, c_slip, c_slip, c_cone, c_cone, c_mask, zero, zero)
    else:
        rows = (c_fb, c_slip, c_slip, c_slip, c_cone, c_mask, zero, zero)
    return torch.stack(rows)


def _wall_res_jac(feet, fh, wh, fm, rho, terrain, wall, mu, s_f,
                  beta=0.03):
    """Closed-form per-foot residuals r (..., 8) and Jacobian J (..., 8, 9)
    of the wall branch w.r.t. zeta = [foot_pos(3), f_hat(3), w(3)]: the
    exact derivatives of `_foot_res` with a wall (the parity tests hold
    them to its jacfwd, and to the JAX package's); rows [fb, slip_x,
    slip_y, slip_z, cone, mask, a, b]. rho broadcasts against feet's
    leading dims.

    With w = sigmoid((gap_g - gap_w) / beta) the blend's weight, the
    normal n = m / |m|, m = w n_wall + (1 - w) up, moves with the foot
    position only through w: dn/dp = u (grad w)^T with u = (I - n n^T)
    (n_wall - up) / |m|, so every p-column below is a vector times grad
    w, plus the gap's own gradient."""
    dtype, dev = feet.dtype, feet.device
    f = s_f * fh
    hg = _height_grad(terrain, feet[..., 0:2])
    gap_g = feet[..., 2] - _height(terrain, feet[..., 0:2])
    gg = torch.cat([-hg, torch.ones_like(hg[..., :1])], -1)   # grad gap_g
    nw = wall.normal.to(dtype)
    up = _const((0.0, 0.0, 1.0), dtype, dev)
    gap_w = terrain_mod.wall_gap(wall, feet)
    wgt = torch.sigmoid((gap_g - gap_w) / beta)
    dwgt = (wgt * (1.0 - wgt) / beta)[..., None] * (gg - nw)   # grad w
    gap = wgt * gap_w + (1.0 - wgt) * gap_g
    dgap = (wgt[..., None] * nw + (1.0 - wgt)[..., None] * gg
            + (gap_w - gap_g)[..., None] * dwgt)
    m = wgt[..., None] * nw + (1.0 - wgt[..., None]) * up
    r_m = torch.sqrt((m * m).sum(-1, keepdim=True) + 1e-12)
    n = m / r_m
    d = nw - up
    u = (d - n * (n * d).sum(-1, keepdim=True)) / r_m

    fn = (f * n).sum(-1)
    ft = f - fn[..., None] * n
    wn = (wh * n).sum(-1)
    wt = wh - wn[..., None] * n
    a = fn / F0
    b = gap / G0
    ftm = torch.sqrt((ft * ft).sum(-1) + 1e-8)
    s = torch.sqrt(a * a + b * b + rho * rho)
    sq = torch.sqrt(_sp(a, rho) + 1e-12)
    dsq = _sigmoid(a / rho) / (2.0 * sq)                    # d sq / d a
    t = (ftm - mu * fn) / F0
    sig_t = _sigmoid(t / rho)
    ftn = (ft * n).sum(-1)

    # d/dp (each a coefficient times grad w, plus the gap's gradient)
    da_p = ((f * u).sum(-1) / F0)[..., None] * dwgt
    db_p = dgap / G0
    dftm_p = (-((ftn[..., None] * f + fn[..., None] * ft) * u).sum(-1)
              / ftm)[..., None] * dwgt
    dwt_p = -(n * (wh * u).sum(-1, keepdim=True)
              + wn[..., None] * u)[..., :, None] * dwgt[..., None, :]
    # d/df_hat
    da_f = (s_f / F0) * n
    dftm_f = s_f * (ft - ftn[..., None] * n) / ftm[..., None]
    # d wt / d w
    perp = (torch.eye(3, dtype=dtype, device=dev)
            - n[..., :, None] * n[..., None, :])

    ca = (1.0 - a / s)[..., None]
    cb = (1.0 - b / s)[..., None]
    zero3 = torch.zeros_like(feet)
    mask = (1.0 - fm)[..., None]

    def row(dp, df, dw):
        return torch.cat([dp, df, dw], -1)
    slip = [row(wt[..., i, None] * dsq[..., None] * da_p + sq[..., None]
                * dwt_p[..., i, :], wt[..., i, None] * dsq[..., None] * da_f,
                sq[..., None] * perp[..., i, :]) for i in range(3)]
    J = torch.stack([
        row(ca * da_p + cb * db_p, ca * da_f, zero3),
        *slip,
        row(sig_t[..., None] * (dftm_p - mu * F0 * da_p) / F0,
            sig_t[..., None] * (dftm_f - mu * F0 * da_f) / F0, zero3),
        row(mask * da_p, mask * da_f, zero3),
        row(da_p, da_f, zero3),
        row(db_p, zero3, zero3)], -2)
    r = torch.stack([a + b - s, sq * wt[..., 0], sq * wt[..., 1],
                     sq * wt[..., 2], _sp(t, rho), (1.0 - fm) * a, a, b], -1)
    return r, J


# per-foot variable positions inside the 48-dim stage vector zu = [z; uh]
_FOOT_IDX = [[12 + 3 * i, 13 + 3 * i, 14 + 3 * i,
              24 + 3 * i, 25 + 3 * i, 26 + 3 * i,
              36 + 3 * i, 37 + 3 * i, 38 + 3 * i] for i in range(4)]


@functools.lru_cache(maxsize=None)
def _foot_scatter(dtype, device):
    """(4, 9, 48) one-hot map of each foot's 9 variables into zu."""
    E = torch.zeros((4, 9, NZ + NU), dtype=dtype, device=device)
    for i, cols in enumerate(_FOOT_IDX):
        E[i, torch.arange(9), torch.tensor(cols)] = 1.0
    return E


def _kernel_form(wts: CiWeights, refs_z, refs_u, f_scale):
    """The solver's inputs in scaled coordinates, as kernel K7 takes them:
    s_u (NU,) with u = s_u * uh, wvec (52,) = [c_fb, c_slip, c_cone,
    c_mask] + the 48-dim tracking diagonal 2 q, and ref_zu (B,H,48)."""
    dtype, dev = refs_z.dtype, refs_z.device
    s_u = torch.cat([torch.full((12,), f_scale, dtype=dtype, device=dev),
                     torch.ones((12,), dtype=dtype, device=dev)])
    track_h = 2.0 * torch.cat([
        wts.q_pos, wts.q_eul, wts.q_vel, wts.q_omega, wts.q_foot.repeat(4),
        (wts.r_f * f_scale * f_scale).expand(12), wts.r_w.expand(12)]
    ).to(dtype)
    wvec = torch.cat([torch.stack([wts.c_fb, wts.c_slip, wts.c_cone,
                                   wts.c_mask]).to(dtype), track_h])
    ref_zu = torch.cat([refs_z[:, :-1], refs_u[..., 0:12] / f_scale,
                        refs_u[..., 12:24]], -1)
    return s_u, wvec, ref_zu


def _quad_core(Zs, Uh, ref_zu, f_mask, terrain, wvec, mu, rho, s_f,
               wall=None):
    """Per-stage exact gradient g (B,H,48) and Gauss-Newton Hessian Hm
    (B,H,48,48) of the stage cost in scaled coordinates, with the
    Fischer-Burmeister curvature restored on its violation side. The
    per-foot residuals and their Jacobians are closed forms, on the ground
    (`_flat_res_jac`) and with a wall (`_wall_res_jac`)."""
    B, H = Uh.shape[0], Uh.shape[1]
    feet = Zs[..., 12:24].reshape(B, H, 4, 3)
    fh = Uh[..., 0:12].reshape(B, H, 4, 3)
    wh = Uh[..., 12:24].reshape(B, H, 4, 3)
    c_fb = wvec[0]
    track_h = wvec[4:]
    if wall is None:
        r, J = _flat_res_jac(feet, fh, wh, f_mask, rho[:, None, None],
                             terrain, mu, s_f)
    else:
        r, J = _wall_res_jac(feet, fh, wh, f_mask, rho[:, None, None],
                             terrain, wall, mu, s_f)
    J48f = torch.einsum("bhfrn,fna->bhfra", J,
                        _foot_scatter(Uh.dtype, Uh.device))
    nres = r.shape[-1]
    J48 = J48f.reshape(B, H, 4 * nres, NZ + NU)
    Wv = _res_weights(wvec[0], wvec[1], wvec[2], wvec[3], wall).repeat(4)
    r_all = r.reshape(B, H, 4 * nres)
    Hm = 2.0 * (J48.transpose(-1, -2) @ (Wv[:, None] * J48))
    g = 2.0 * (J48.transpose(-1, -2) @ (Wv * r_all)[..., None])[..., 0]
    # the Gauss-Newton Hessian drops 2 c_fb r hess(r) of the FB penalty; on
    # the r < 0 side (force at distance, penetration) that term is PSD and
    # carries the stiffness that keeps the plan off a riser it would
    # penetrate: hess_ab(FB) = (v v^T - s^2 I) / s^3, v = (a, b)
    a_v, b_v = r[..., nres - 2], r[..., nres - 1]
    s_v = torch.sqrt(a_v * a_v + b_v * b_v + rho[:, None, None] ** 2)
    m_v = 2.0 * c_fb * torch.clamp(r[..., 0], max=0.0) / s_v ** 3
    Ja, Jb = J48f[..., nres - 2, :], J48f[..., nres - 1, :]

    def outer(c, X, Y):
        return (c[..., None] * X).transpose(-1, -2) @ Y
    c_ab = m_v * (a_v * b_v)
    Hm = Hm + (outer(m_v * (a_v * a_v - s_v * s_v), Ja, Ja)
               + outer(m_v * (b_v * b_v - s_v * s_v), Jb, Jb)
               + outer(c_ab, Ja, Jb) + outer(c_ab, Jb, Ja))
    zu = torch.cat([Zs, Uh], -1)
    g = g + track_h * (zu - ref_zu)
    Hm = Hm + torch.diag(track_h)
    return g, Hm


def _quad_ggn_b(Zs, Uh, refs_z, refs_u, f_mask, terrain, wall, wts, mu,
                rho, s_f):
    """Per-stage gradient (exact) and Gauss-Newton Hessian (PSD) of the
    stage cost in scaled coordinates. Zs (B,H,NZ), Uh (B,H,NU), rho (B,).
    Returns g (B,H,48), Hm (B,H,48,48)."""
    _, wvec, ref_zu = _kernel_form(wts, refs_z, refs_u, s_f)
    return _quad_core(Zs, Uh, ref_zu, f_mask, terrain, wvec, mu, rho, s_f,
                      wall)


def _traj_cost_k(Z, Uh, ref_zu, refT, f_mask, terrain, wvec, mu, rho, s_f,
                 wall=None):
    """Total cost in the solver's scaled coordinates: Z (..., B, H+1, NZ),
    Uh (..., B, H, NU), rho (B,). Returns (..., B)."""
    lead = Uh.shape[:-1]
    c_fb, c_slip, c_cone, c_mask = wvec[0], wvec[1], wvec[2], wvec[3]
    track_h = wvec[4:]
    Zs = Z[..., :-1, :]
    d = torch.cat([Zs, Uh], -1) - ref_zu
    stage = 0.5 * (track_h * d * d).sum(-1)
    feet = Zs[..., 12:24].reshape(lead + (4, 3))
    f = s_f * Uh[..., 0:12].reshape(lead + (4, 3))
    w = Uh[..., 12:24].reshape(lead + (4, 3))
    rho4 = rho[:, None, None]
    if wall is None:
        a = f[..., 2] / F0
        b = (feet[..., 2] - _height(terrain, feet[..., 0:2])) / G0
        t4 = (f[..., 0].abs() - mu * f[..., 2]) / F0
        t5 = (f[..., 1].abs() - mu * f[..., 2]) / F0
        comp = (c_fb * _fb(a, b, rho4) ** 2
                + c_slip * _sp(a, rho4) * (w[..., 0] ** 2 + w[..., 1] ** 2)
                + c_cone * (_sp(t4, rho4) ** 2 + _sp(t5, rho4) ** 2))
    else:
        comp, a = _wall_comp(f, w, feet, terrain, wall, mu, rho4, c_fb,
                             c_slip, c_cone)
    stage = stage + (comp + c_mask * ((1.0 - f_mask) * a) ** 2).sum(-1)
    dT = Z[..., -1, :] - refT
    hT = track_h[:NZ].clone()
    hT[9:] = 0.0
    return stage.sum(-1) + 0.5 * (hT * dT * dT).sum(-1)


def _sweeps(z0, Uh0, ref_zu, refT, f_mask, rho0, wvec, mu, mass, Iw_inv,
            terrain, *, iters, dt, s_f, rho_min, reg, state_reg, solve,
            keep_nominal, wall=None):
    """The Gauss-Newton iLQR sweep loop in scaled coordinates (the
    arguments of kernel K7, plus the terrain, the wall, which both the
    quadratization and the line-search cost see, and the gain solve
    `solve(A (B,n,n), rhs (B,n,m))`). keep_nominal: the line-search rule
    of kernel K7 (a scenario whose five candidates are all non-finite
    keeps its nominal); False: the JAX "xla" rule (it commits alpha = 1).
    Returns (Uh, Z, cost of the last sweep)."""
    B, H = Uh0.shape[0], Uh0.shape[1]
    dtype, dev = z0.dtype, z0.device
    track_h = wvec[4:]
    hT = track_h[:NZ].clone()
    hT[9:] = 0.0
    eyeU = torch.eye(NU, dtype=dtype, device=dev)
    alphas = _const(ALPHAS, dtype, dev)[:, None]              # (A, 1)
    rho0 = rho0.to(dtype)

    def backward(Z, Uh, rho):
        Zs = Z[:, :-1]
        Fz, Fu = _dyn_jac_b(Zs, Uh, mass, Iw_inv, dt, s_f)
        g, Hm = _quad_core(Zs, Uh, ref_zu, f_mask, terrain, wvec, mu, rho,
                           s_f, wall)
        F = torch.cat([Fz, Fu], -1)                           # (B,H,24,48)
        FuT = Fu.transpose(-1, -2)
        # Levenberg state-space regularization (Tassa'12): the gains come
        # from the mu_x-damped system, the value update keeps the canonical
        # form. Tames the feet -> attitude coupling.
        Rr = reg * eyeU + state_reg * (FuT @ Fu)
        Rx = state_reg * (FuT @ Fz)
        Vx = hT * (Z[:, -1] - refT)
        Vxx = torch.diag(hT).expand(B, NZ, NZ)
        kff = torch.empty((B, H, NU), dtype=dtype, device=dev)
        K = torch.empty((B, H, NU, NZ), dtype=dtype, device=dev)
        for k in range(H - 1, -1, -1):
            Fk = F[:, k]
            FkT = Fk.transpose(-1, -2)
            Q = Hm[:, k] + FkT @ (Vxx @ Fk)
            q = g[:, k] + (FkT @ Vx[..., None])[..., 0]
            Qx, Qu = q[:, :NZ], q[:, NZ:]
            Qxx, Quu, Qux = Q[:, :NZ, :NZ], Q[:, NZ:, NZ:], Q[:, NZ:, :NZ]
            sol = solve(Quu + Rr[:, k],
                        torch.cat([Qu[..., None], Qux + Rx[:, k]], 2))
            # non-finite stage guard (per scenario): zero that stage's
            # correction; the line search still vets the cost
            okk = torch.isfinite(sol).all(-1).all(-1)[:, None, None]
            sol = torch.where(okk, -sol, torch.zeros_like(sol))
            kf, Kk = sol[:, :, 0], sol[:, :, 1:]
            KT = Kk.transpose(-1, -2)
            QuxT = Qux.transpose(-1, -2)
            KtQuu = KT @ Quu
            Vx2 = (Qx + (KtQuu @ kf[..., None])[..., 0]
                   + (KT @ Qu[..., None])[..., 0]
                   + (QuxT @ kf[..., None])[..., 0])
            Vxx2 = Qxx + KtQuu @ Kk + KT @ Qux + QuxT @ Kk
            Vxx2 = 0.5 * (Vxx2 + Vxx2.transpose(-1, -2))
            okv = (torch.isfinite(Vx2).all(-1)
                   & torch.isfinite(Vxx2).all(-1).all(-1))
            Vx = torch.where(okv[:, None], Vx2, Vx)
            Vxx = torch.where(okv[:, None, None], Vxx2, Vxx)
            kff[:, k], K[:, k] = kf, Kk
        return kff, K

    def forward(Z, Uh, kff, K):
        """All five candidates at once: (A, B, H, NU), (A, B, H+1, NZ).
        alpha = 0 reproduces the nominal exactly (the feedback term
        vanishes along the nominal rollout)."""
        z = Z[:, 0].expand((len(ALPHAS),) + Z[:, 0].shape)
        Us, Zn = [], [z]
        for k in range(H):
            u = (Uh[:, k] + alphas[..., None] * kff[:, k]
                 + (K[:, k] @ (z - Z[:, k])[..., None])[..., 0])
            z = _dyn_b(z, u, mass, Iw_inv, dt, s_f)
            Us.append(u)
            Zn.append(z)
        return torch.stack(Us, 2), torch.stack(Zn, 2)

    Uh = Uh0
    Z = _rollout_b(z0, Uh0, mass, Iw_inv, dt, s_f)
    cost = None
    ar = torch.arange(B, device=dev)
    for it in range(iters):
        frac = it / (iters - 1.0) if iters > 1 else 1.0
        if keep_nominal:
            lr0 = torch.log(rho0)
            rho = torch.clamp(torch.exp(lr0 + frac * (math.log(rho_min)
                                                      - lr0)), min=rho_min)
        else:
            rho = torch.clamp(rho0 * (rho_min / rho0) ** frac, min=rho_min)
        kff, K = backward(Z, Uh, rho)
        U2s, Z2s = forward(Z, Uh, kff, K)
        cs = _traj_cost_k(Z2s, U2s, ref_zu, refT, f_mask, terrain, wvec, mu,
                          rho, s_f, wall)
        cs = torch.where(torch.isfinite(cs), cs,
                         torch.full_like(cs, math.inf))
        cost, best = cs.min(0)          # the first minimum on ties
        if keep_nominal:
            best = torch.where(torch.isinf(cost),
                               torch.full_like(best, len(ALPHAS) - 1), best)
        Uh, Z = U2s[best, ar], Z2s[best, ar]
    return Uh, Z, cost


def _psd_solve_b(A, rhs, backend):
    """Batched SPD solve A (B,n,n), rhs (B,n,m) -> A^{-1} rhs: kernels K4 +
    K6 ("lanes"; their plain versions on CPU tensors) or the library
    Cholesky ("plain"). A non-positive-definite A gives non-finite values,
    which the sweeps' stage guard zeroes."""
    if backend == "lanes":
        F = chol_kernel.cholesky_cuda(A)
        return chol_kernel.cho_solve_multi_cuda(F, rhs)
    F = chol_kernel.cholesky_plain(A)
    return chol_kernel.cho_solve_multi_plain(F, rhs)


def ci_pallas_available(terrain, wall, horizon, dtype=torch.float32) -> bool:
    """True where the fused kernel K7 serves the problem: flat-zero
    terrain, no wall, H <= 12, float32 (the TPU kernel's conditions, kept
    so both packages dispatch the same problems the same way; K7 itself
    has no horizon cap)."""
    return (wall is None and horizon <= MAX_H_FUSED
            and dtype == torch.float32
            and (terrain is None or terrain_mod.is_flat_zero(terrain)))


@trace.spanned(trace.CI_SOLVE)
def ci_solve_batched(z0, U0, refs_z, refs_u, terrain, mass, inertia_w, mu,
                     wts: CiWeights = None, f_mask=None, *, iters=16,
                     dt=0.02, rho0=0.5, rho_min=0.05, reg=1e-2,
                     state_reg=1e-1, f_scale=F0, wall=None, backend=None):
    """Batch-native Gauss-Newton iLQR with an annealed complementarity
    relaxation: one solve for a whole scenario batch.

    z0 (B,NZ), U0 (B,H,NU) input warm starts, refs_z (B,H+1,NZ), refs_u
    (B,H,NU); terrain: a `sim.terrain.Terrain` shared by the batch (None:
    flat ground); mass, mu scalars; inertia_w (B,3,3) world-frame at each
    scenario's yaw; f_mask optional (B,H,4); rho0 scalar or (B,) initial
    relaxation; iters fixed sweep count (rho0 -> rho_min geometrically).
    Force channels are optimized in units of `f_scale` N and the gain
    solve uses Levenberg state regularization Quu + mu_x Fu'Fu.

    wall: an optional vertical `sim.terrain.Wall` shared by the batch (the
    lean), seen by the quadratization and the line search.

    backend: "fused", "lanes" or "plain" (module docstring); None picks
    "fused" where `ci_pallas_available` holds, else "lanes" on the card
    and "plain" on the CPU. "fused" with a non-flat terrain or a wall
    raises (kernel K7 serves flat ground only).

    Returns (U (B,H,NU), Z (B,H+1,NZ), cost (B,)) at the tightest
    relaxation.
    """
    dtype, dev = z0.dtype, z0.device
    B, H = U0.shape[0], U0.shape[1]
    if backend is None:
        if ci_pallas_available(terrain, wall, H, dtype):
            backend = "fused"
        else:
            backend = "lanes" if dev.type == "cuda" else "plain"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of "
                         f"{BACKENDS}")
    if wts is None:
        wts = _cached_weights(dtype, dev)
    if f_mask is None:
        f_mask = torch.ones((B, H, 4), dtype=dtype, device=dev)
    s_u, wvec, ref_zu = _kernel_form(wts, refs_z, refs_u, f_scale)
    Iw_inv = torch.linalg.inv(inertia_w)
    rho0 = torch.as_tensor(rho0, dtype=dtype, device=dev).expand(B)
    mass = torch.as_tensor(mass, dtype=dtype, device=dev)
    mu = torch.as_tensor(mu, dtype=dtype, device=dev)
    kw = dict(iters=iters, dt=dt, s_f=f_scale, rho_min=rho_min, reg=reg,
              state_reg=state_reg)
    if backend == "fused":
        if wall is not None:
            raise ValueError("backend 'fused' (kernel K7) serves no wall; "
                             "use 'lanes' for the wall branch")
        if not (terrain is None or terrain_mod.is_flat_zero(terrain)):
            raise ValueError("backend 'fused' (kernel K7) serves flat-zero "
                             "terrain only; use 'lanes' for a height field")
        Uh, Z, cost = ci_kernel.ci_sweeps_cuda(
            z0, U0 / s_u, ref_zu, refs_z[:, -1], f_mask, rho0, wvec, mu,
            mass, Iw_inv, **kw)
    else:
        Uh, Z, cost = _sweeps(
            z0, U0 / s_u, ref_zu, refs_z[:, -1], f_mask, rho0, wvec, mu,
            mass, Iw_inv, terrain,
            solve=functools.partial(_psd_solve_b, backend=backend),
            keep_nominal=False, wall=wall, **kw)
    return s_u * Uh, Z, cost


def ci_solve(z0, U0, refs_z, refs_u, terrain, mass, inertia_w, mu,
             wts: CiWeights = None, f_mask=None, **kw):
    """Single-scenario solve, the B=1 view of `ci_solve_batched`: z0 (NZ,),
    U0 (H,NU), refs_z (H+1,NZ), refs_u (H,NU), inertia_w (3,3), f_mask
    optional (H,4). Returns (U (H,NU), Z (H+1,NZ), cost ())."""
    fm = None if f_mask is None else f_mask[None]
    U, Z, cost = ci_solve_batched(
        z0[None], U0[None], refs_z[None], refs_u[None], terrain, mass,
        inertia_w[None], mu, wts, fm, **kw)
    return U[0], Z[0], cost[0]


def make_ci_reference(z0, t, terrain, params, velx=0.2, body_height=0.3,
                      gait_freq=None, swing_clearance=0.06, horizon=10,
                      dt_plan=0.02, offsets=(0.0, 0.5, 0.5, 0.0),
                      stance_frac=0.5):
    """Trot-template references of a batch: z0 (B,NZ), t (B,) the policy
    clock; params unbatched. Returns (refs_z (B,H+1,NZ), refs_u (B,H,NU),
    U0 = refs_u). The template carries the preferred gait rhythm and
    terrain-aware foothold arcs; complementarity against the real height
    field decides the actual contact."""
    dtype, dev = z0.dtype, z0.device
    B = z0.shape[0]
    if gait_freq is None:
        gait_freq = float(params.gait_counter_speed)
    pos, eul, v = z0[:, 0:3], z0[:, 3:6], z0[:, 6:9]
    feet0 = z0[:, 12:24].reshape(B, 4, 3)
    yaw = eul[:, 2]
    Rz = so3.rot_z(yaw)
    vcmd = _const((velx, 0.0, 0.0), dtype, dev).expand(B, 3)
    v_d = (Rz @ vcmd[..., None])[..., 0]

    # footholds: the Raibert target, z snapped to the terrain
    target_abs, _ = raibert.raibert_footholds(pos, v, Rz, vcmd, params,
                                              terrain=terrain)
    target_world = target_abs + pos[:, None]
    tgt_h = _height(terrain, target_world[..., 0:2])
    target_world = torch.cat([target_world[..., 0:2], tgt_h[..., None]], -1)

    # template clock: offsets/stance_frac select the gait
    offs = _const(tuple(offsets), dtype, dev)
    ks = torch.arange(horizon + 1, dtype=dtype, device=dev)
    phase_k = torch.remainder((t[:, None] + ks * dt_plan)[..., None]
                              * gait_freq + offs, 1.0)     # (B,H+1,4)
    stance_k = phase_k < stance_frac
    # complete the swing by 75 % of the swing window, so the plan reaches
    # the foothold before the clock flips the leg to stance
    swing_s = torch.clamp((phase_k - stance_frac) / (1.0 - stance_frac)
                          / 0.75, 0.0, 1.0)

    # body: terrain-following height approached at a bounded rate, with
    # the matching vertical velocity reference
    z_rate = 0.3
    pos_k = pos[:, None] + ks[:, None] * dt_plan * v_d[:, None]
    ground_k = _height(terrain, pos_k[..., 0:2])
    z_tgt = ground_k + body_height
    dz = z_tgt - pos[:, 2:3]
    lim = z_rate * ks * dt_plan
    z_k = pos[:, 2:3] + torch.clamp(dz, -lim, lim)
    pos_k = torch.cat([pos_k[..., 0:2], z_k[..., None]], -1)
    vz_k = torch.diff(z_k, dim=1, append=z_k[:, -1:]) / dt_plan
    eul_k = (_const((0.0, 0.0, 1.0), dtype, dev)
             * yaw[:, None, None]).expand(B, horizon + 1, 3)

    # feet: stance holds the terrain-snapped foothold, swing arcs toward
    # it; the arc's height is anchored to the terrain under liftoff and
    # landing, not to the live foot z (that would ratchet the swing up)
    hold = torch.where(stance_k[:, 0, :, None], feet0, target_world)
    ground0 = _height(terrain, feet0[..., 0:2])
    lerp = (feet0[:, None] * (1.0 - swing_s)[..., None]
            + target_world[:, None] * swing_s[..., None])
    arc_z = ((1.0 - swing_s) * ground0[:, None] + swing_s * tgt_h[:, None]
             + swing_clearance * torch.sin(math.pi * swing_s))
    swing_traj = torch.cat([lerp[..., 0:2], arc_z[..., None]], -1)
    feet_k = torch.where(stance_k[..., None], hold[:, None], swing_traj)

    v_k = torch.cat([v_d[:, None, 0:2].expand(B, horizon + 1, 2),
                     vz_k[..., None]], -1)
    refs_z = torch.cat([
        pos_k, eul_k, v_k,
        torch.zeros((B, horizon + 1, 3), dtype=dtype, device=dev),
        feet_k.reshape(B, horizon + 1, 12)], -1)

    # inputs: the weight shared over template-stance feet, foot velocities
    # from the template foot-path differences
    st = stance_k[:, :-1].to(dtype)
    n_st = torch.clamp(st.sum(-1), min=1.0)
    fz0 = (params.mass.to(dtype) * GRAV / n_st)[..., None] * st
    f_ref = torch.zeros((B, horizon, 4, 3), dtype=dtype, device=dev)
    f_ref[..., 2] = fz0
    w_ref = (feet_k[:, 1:] - feet_k[:, :-1]) / dt_plan
    refs_u = torch.cat([f_ref.reshape(B, horizon, 12),
                        w_ref.reshape(B, horizon, 12)], -1)
    return refs_z, refs_u, refs_u


@trace.spanned(trace.CI_PREP)
def _walk_prep(x, t, params, terrain, velx, body_height, gait_freq,
               horizon, dt_plan, offsets, stance_frac):
    """Per-scenario prep of the CI walk policy, batched: x (B,40), t (B,).
    State packing, trot-template references, world-yaw inertia and the
    measured-support stage-0 mask."""
    dtype = x.dtype
    B = x.shape[0]
    pos, eul = x[:, 0:3], x[:, 3:6]
    foot_abs = x[:, 6:18].reshape(B, 4, 3)      # CoM-origin world axes
    v, omega = x[:, 18:21], x[:, 21:24]
    feet_w = foot_abs + pos[:, None]
    z0 = torch.cat([pos, eul, v, omega, feet_w.reshape(B, 12)], -1)
    refs_z, refs_u, U0 = make_ci_reference(
        z0, t, terrain, params, velx=velx, body_height=body_height,
        gait_freq=gait_freq, horizon=horizon, dt_plan=dt_plan,
        offsets=offsets, stance_frac=stance_frac)
    Rz = so3.rot_z(eul[:, 2])
    inertia_w = Rz @ params.trunk_inertia.to(dtype) @ Rz.transpose(-1, -2)
    # stage 0 carries the measured support: only feet that are down
    # (position gap or registered force) may push now
    gap0 = feet_w[..., 2] - _height(terrain, feet_w[..., 0:2])
    grounded_now = ((x[:, 36:40] > 2.0) | (gap0 < 0.003)).to(dtype)
    f_mask = torch.ones((B, horizon, 4), dtype=dtype, device=x.device)
    f_mask[:, 0] = grounded_now
    return z0, refs_z, refs_u, U0, inertia_w, f_mask, grounded_now, feet_w


@trace.spanned(trace.CI_POST)
def _walk_post(U, Z, refs_z, grounded_now, feet_w, terrain, fz_min):
    """A CI walk solve into the (B, 78) seam output: support gating,
    touchdown press, swing targets."""
    dtype, dev = U.dtype, U.device
    B = U.shape[0]
    f0 = U[:, 0, 0:12].reshape(B, 4, 3)
    loaded = (f0[..., 2] > fz_min).to(dtype)
    # execute force only through feet that both the plan loads and the
    # robot reports grounded; loaded feet not yet registering force get a
    # bootstrap push so the contact can establish
    support = loaded * grounded_now
    boot = ((loaded * (1.0 - grounded_now))[..., None]
            * _const((0.0, 0.0, 2.0 * max(fz_min, 5.0)), dtype, dev))
    u = (f0 * support[..., None] + boot).reshape(B, 12)
    # desired feet: the optimized path one planning step ahead; loaded and
    # grounded feet hold, loaded airborne feet aim 1 cm below the surface
    foot_tgt = Z[:, 1, 12:24].reshape(B, 4, 3)
    g_tgt = _height(terrain, foot_tgt[..., 0:2])
    press = torch.cat([foot_tgt[..., 0:2], (g_tgt - 0.01)[..., None]], -1)
    stance_tgt = torch.where(grounded_now[..., None] > 0.5, feet_w, press)
    foot_tgt = torch.where(loaded[..., None] > 0.5, stance_tgt, foot_tgt)
    state_des = torch.cat([refs_z[:, 1, 0:3], refs_z[:, 1, 3:6],
                           foot_tgt.reshape(B, 12)], -1)
    vel_des = torch.cat([refs_z[:, 1, 6:9],
                         torch.zeros((B, 3), dtype=dtype, device=dev),
                         U[:, 0, 12:24]], -1)
    return torch.cat([u, state_des, vel_des, state_des,
                      torch.zeros((B, 12), dtype=dtype, device=dev)], -1)


def make_ci_walk_policy_batched(params, terrain=None, velx=0.1,
                                body_height=0.3, gait_freq=2.5,
                                horizon=10, dt_plan=0.02, iters=24,
                                fz_min=2.0, wts: CiWeights = None,
                                offsets=(0.0, 0.5, 0.5, 0.0),
                                stance_frac=0.5, rho_warm=0.15,
                                backend=None):
    """The CI walk policy of a batch, `(x (B,40), t, warm) -> ((B,78),
    warm')`, for `lci_mpc.lci_mpc_tick_batched`: batched prep, one
    `ci_solve_batched`, batched post. Each tick re-solves from the measured
    state, warm-started from the previous tick's inputs; a warm scenario
    starts the anneal at `rho_warm` (a cold one at 0.5). terrain None is
    flat ground. warm slot: {"u": (B,H,NU), "valid": (B,)}."""
    if gait_freq is None:
        gait_freq = float(params.gait_counter_speed)

    def policy(x, t, warm):
        dtype, dev = x.dtype, x.device
        B = x.shape[0]
        t_b = torch.as_tensor(t, dtype=dtype, device=dev).expand(B)
        (z0, refs_z, refs_u, U0, inertia_w, f_mask, grounded_now,
         feet_w) = _walk_prep(x, t_b, params, terrain, velx, body_height,
                              gait_freq, horizon, dt_plan, offsets,
                              stance_frac)
        valid = warm["valid"] > 0.5
        U0 = torch.where(valid[:, None, None], warm["u"], U0)
        rho0 = torch.full((B,), 0.5, dtype=dtype, device=dev)
        if rho_warm is not None:
            rho0 = torch.where(valid, torch.full_like(rho0, rho_warm), rho0)
        U, Z, _cost = ci_solve_batched(
            z0, U0, refs_z, refs_u, terrain, params.mass.to(dtype),
            inertia_w, params.mu.to(dtype), wts, f_mask, iters=iters,
            dt=dt_plan, rho0=rho0, backend=backend)
        out = _walk_post(U, Z, refs_z, grounded_now, feet_w, terrain, fz_min)
        return out, {"u": U, "valid": torch.ones((B,), dtype=dtype,
                                                 device=dev)}

    def warm_init(batch, dtype=torch.float32, device="cuda"):
        device = resolve_device(device)
        return {"u": torch.zeros((batch, horizon, NU), dtype=dtype,
                                 device=device),
                "valid": torch.zeros((batch,), dtype=dtype, device=device)}

    policy.ci_stateful = True
    policy.ci_batched = True
    policy.warm_init = warm_init
    return policy


def make_ci_walk_policy(params, terrain=None, velx=0.1, body_height=0.3,
                        gait_freq=2.5, horizon=10, dt_plan=0.02, iters=32,
                        fz_min=2.0, wts: CiWeights = None,
                        offsets=(0.0, 0.5, 0.5, 0.0), stance_frac=0.5,
                        rho_warm=0.15, backend=None):
    """The single-robot CI walk policy `(x (40,), t, warm) -> ((78,),
    warm')`, the B=1 view of `make_ci_walk_policy_batched` (the `--mpc ci`
    MPC-thread body). warm slot: {"u": (H,NU), "valid": ()}."""
    batched = make_ci_walk_policy_batched(
        params, terrain=terrain, velx=velx, body_height=body_height,
        gait_freq=gait_freq, horizon=horizon, dt_plan=dt_plan, iters=iters,
        fz_min=fz_min, wts=wts, offsets=offsets, stance_frac=stance_frac,
        rho_warm=rho_warm, backend=backend)

    def policy(x, t, warm):
        out, w = batched(x[None], t, {k: v[None] for k, v in warm.items()})
        return out[0], {k: v[0] for k, v in w.items()}

    def warm_init(dtype=torch.float32, device="cuda"):
        return {k: v[0] for k, v in
                batched.warm_init(1, dtype, device).items()}

    policy.ci_stateful = True
    policy.warm_init = warm_init
    return policy


def make_ci_lean_reference(z0, wall, feet_target, body_pos, body_eul,
                           params, terrain, horizon=10, dt_plan=0.02,
                           balance_pos=None, balance_feet=None):
    """Wall-lean hold template of a batch (reference capability: README.md:14
    "lean against wall"): every stage holds the lean pose, the body at
    (body_pos, body_eul) (3,) or (B,3) and the feet at feet_target (4,3) or
    (B,4,3), typically the front feet on the wall plane and the rear feet
    on the ground. z0 (B,NZ); terrain None is flat ground.

    The input template is an equilibrium at the wall-normal preload
    f_wall_n = 20 N: planar (x-z) static balance over the n_wall wall feet
    and the n_ground ground feet,
        fx_ground = -fn n_x n_wall / n_ground       (cancel the wall press)
        n_wall fw + n_ground fz = m g               (weight)
        n_wall r_wx fw + n_ground r_gx fz
            = n_wall fn (r_gz - r_wz) (-n_x)        (pitch torque)
    solved for the wall feet's vertical share fw (clipped to 0.9 mu fn) and
    the ground load fz, with the levers taken from balance_pos (B,3) and
    balance_feet (B,4,3) when given (the policy passes the measured pose,
    so the template is an equilibrium where the robot stands). A clipped
    proportional velocity reference turns the pose error into motion the
    first stage executes. The complementarity, not the template, owns the
    physics. Returns (refs_z (B,H+1,NZ), refs_u (B,H,NU), U0 = refs_u)."""
    dtype, dev = z0.dtype, z0.device
    B = z0.shape[0]
    tgt = feet_target.to(dtype).expand(B, 4, 3)
    body_pos = body_pos.to(dtype).expand(B, 3)
    body_eul = body_eul.to(dtype).expand(B, 3)
    _, n = env_gap_normal(terrain, wall, tgt)
    on_wall = (terrain_mod.wall_gap(wall, tgt)
               < tgt[..., 2] - _height(terrain, tgt[..., 0:2]))  # (B,4)
    ow = on_wall[..., None]
    mg = params.mass.to(dtype) * GRAV
    mu = params.mu.to(dtype)
    n_wall = torch.clamp(on_wall.sum(-1), min=1).to(dtype)
    n_ground = torch.clamp((~on_wall).sum(-1), min=1).to(dtype)
    f_wall_n = 20.0
    body = body_pos if balance_pos is None else balance_pos
    bal_feet = tgt if balance_feet is None else balance_feet
    zero = torch.zeros_like(bal_feet)
    r_w = torch.where(ow, bal_feet - body[:, None], zero).sum(1) \
        / n_wall[:, None]
    r_g = torch.where(ow, zero, bal_feet - body[:, None]).sum(1) \
        / n_ground[:, None]
    nx = torch.where(ow, n, torch.zeros_like(n)).sum(1)[:, 0] / n_wall
    # 2x2 solve in the aggregates a = n_wall fw, b = n_ground fz:
    #   [1, 1; r_wx, r_gx] [a, b] = [m g, c2]
    c2 = n_wall * f_wall_n * (r_g[:, 2] - r_w[:, 2]) * (-nx)
    det = r_g[:, 0] - r_w[:, 0]
    # a sign-preserving clamp of a degenerate geometry (a fixed +eps would
    # flip the solve's sign for a small negative det)
    eps = torch.where(det < 0, -torch.ones_like(det), torch.ones_like(det))
    safe_det = torch.where(det.abs() < 1e-6, 1e-6 * eps, det)
    a = (c2 - r_g[:, 0] * mg) / (-safe_det)
    cap = 0.9 * mu * f_wall_n
    fw = torch.minimum(torch.maximum(a / n_wall, -cap), cap)
    fz_g = (mg - n_wall * fw) / n_ground
    up = _const((0.0, 0.0, 1.0), dtype, dev)
    f_wall = f_wall_n * n + up * fw[:, None, None]
    fx_g = (-f_wall_n * nx * n_wall / n_ground)[:, None].expand(B, 4)
    f_ground = torch.stack([fx_g, torch.zeros_like(fx_g),
                            fz_g[:, None].expand(B, 4)], -1)
    f0 = torch.where(ow, f_wall, f_ground)
    # restoring velocity references toward the nominal pose: with zero
    # references the velocity-damped plan hovers wherever the tick starts,
    # and a realized-force surplus integrates into drift
    v_ref = torch.clamp(1.5 * (body_pos - z0[:, 0:3]), -0.15, 0.15)
    om_ref = torch.clamp(2.0 * (body_eul - z0[:, 3:6]), -0.3, 0.3)
    zr = torch.cat([body_pos, body_eul, v_ref, om_ref, tgt.reshape(B, 12)],
                   -1)
    refs_z = zr[:, None].expand(B, horizon + 1, NZ)
    refs_u = torch.cat([f0.reshape(B, 12), torch.zeros_like(f0).reshape(
        B, 12)], -1)[:, None].expand(B, horizon, NU)
    return refs_z, refs_u, refs_u


def make_ci_lean_policy(params, wall, feet_target, body_pos, body_eul,
                        terrain=None, horizon=10, dt_plan=0.02, iters=24,
                        fz_min=2.0, wts: CiWeights = None,
                        wall_press_m=None):
    """The contact-implicit engine holding a wall lean as a single-robot
    stateful LciMpc-seam policy `(x (40,), t, warm) -> ((78,), warm')`, the
    contract of `make_ci_walk_policy` (the JAX package has no batched
    lean). Each tick re-solves the CI optimization from the measured state
    against the ground and the wall (`ci_solve_batched(wall=...)`: K4 + K6
    on the card); the per-foot contact normal, and with it the friction
    geometry that lets the wall feet carry weight, comes out of
    `env_gap_normal`, not a schedule. feet_target (4,3), body_pos and
    body_eul (3,) tensors: the lean pose (`make_ci_lean_reference`);
    terrain None is flat ground. warm slot: {"u": (H,NU), "valid": ()}.

    The lean weights (when `wts` is None) raise r_f tenfold (the template
    must be tracked: the minimal-force member of the lean equilibria rides
    the friction cone, and the wall feet creep down) and the roll weight to
    150 (the two-surface stance couples roll into wall-foot load
    asymmetry); the other weights are the float32 defaults, as in the JAX
    package. The wall press depth is 0.03 / mean(kp_foot) m (a spring
    preload normalized across robots: A1 kp 15 -> 2 mm, Go1 kp 30 -> 1 mm),
    read once here."""
    if wall_press_m is None:
        press_m = 0.03 / float(params.kp_foot.double().mean())
    else:
        press_m = float(wall_press_m)

    @functools.lru_cache(maxsize=None)
    def consts(dtype, device):
        """The lean's constants on the card, made once: the pose, the
        weights, the cold relaxation."""
        def c(v):
            return v.to(dtype=dtype, device=device)
        if wts is None:
            w = _cached_weights(torch.float32, device)
            w = CiWeights(**{k: c(v) for k, v in vars(w).items()})
            w = w.replace(r_f=torch.tensor(1e-2, dtype=dtype, device=device),
                          q_eul=torch.tensor([150.0, 60.0, 60.0],
                                             dtype=dtype, device=device))
        else:
            w = CiWeights(**{k: c(v) for k, v in vars(wts).items()})
        return (c(feet_target), c(body_pos), c(body_eul), w,
                torch.tensor(0.5, dtype=dtype, device=device))

    def batched(x, warm):
        dtype, dev = x.dtype, x.device
        B = x.shape[0]
        tgt, bpos, beul, w, rho0 = consts(dtype, dev)
        pos, eul = x[:, 0:3], x[:, 3:6]
        foot_abs = x[:, 6:18].reshape(B, 4, 3)
        v, omega = x[:, 18:21], x[:, 21:24]
        feet_w = foot_abs + pos[:, None]
        gap0, n0 = env_gap_normal(terrain, wall, feet_w)
        # contact gate at 15 mm (the walk's is 3 mm): a wall foot reads ~0
        # on the world-z force sensor, so geometry is its only contact
        # evidence, and the controller's deliberately mismatched leg
        # kinematics projects up to ~11 mm of wall-gap bias at the lean's
        # extended front-leg pose; the lean keeps all four feet down, so a
        # generous gate mis-gates no swing
        grounded_now = ((x[:, 36:40] > 2.0) | (gap0 < 0.015)).to(dtype)
        # contact-aided foot correction: feet in contact snap onto the
        # surface along its normal, so the measured kinematic bias does not
        # read as penetration the optimizer would be rewarded to load
        feet_corr = feet_w - (grounded_now * gap0)[..., None] * n0
        z0 = torch.cat([pos, eul, v, omega, feet_corr.reshape(B, 12)], -1)
        refs_z, refs_u, U0 = make_ci_lean_reference(
            z0, wall, tgt, bpos, beul, params, terrain, horizon=horizon,
            dt_plan=dt_plan, balance_pos=pos, balance_feet=feet_corr)
        Rz = so3.rot_z(eul[:, 2])
        inertia_w = Rz @ params.trunk_inertia.to(dtype) @ Rz.transpose(-1,
                                                                       -2)
        f_mask = torch.ones((B, horizon, 4), dtype=dtype, device=dev)
        f_mask[:, 0] = grounded_now
        U0 = torch.where(warm["valid"][:, None, None] > 0.5, warm["u"], U0)
        U, Z, _cost = ci_solve_batched(
            z0, U0, refs_z, refs_u, terrain, params.mass.to(dtype),
            inertia_w, params.mu.to(dtype), w, f_mask, iters=iters,
            dt=dt_plan, rho0=rho0, wall=wall)

        f0 = U[:, 0, 0:12].reshape(B, 4, 3)
        loaded = ((f0 * n0).sum(-1) > fz_min).to(dtype)
        support = loaded * grounded_now
        boot = ((loaded * (1.0 - grounded_now))[..., None]
                * (2.0 * max(fz_min, 5.0)) * n0)
        u = (f0 * support[..., None] + boot).reshape(B, 12)

        # stance fix-up: ground feet hold their measured position; wall
        # feet press a target pinned inside the plane (a steady spring
        # preload; holding the measured position against the stiff wall
        # turns contact chatter into command chatter). A foot judged in
        # contact presses only press_m beyond its measured position (its
        # measured wall gap is kinematic bias); an airborne one closes its
        # gap too
        gap_w0 = terrain_mod.wall_gap(wall, feet_w)
        gap_g0 = feet_w[..., 2] - _height(terrain, feet_w[..., 0:2])
        on_wall0 = gap_w0 < gap_g0
        foot_tgt = Z[:, 1, 12:24].reshape(B, 4, 3)
        drive = torch.where(grounded_now > 0.5, torch.zeros_like(gap_w0),
                            gap_w0)
        press_wall = (feet_w - (drive + press_m)[..., None]
                      * wall.normal.to(dtype))
        press_gnd = foot_tgt - 0.01 * n0
        stance_tgt = torch.where(grounded_now[..., None] > 0.5, feet_w,
                                 press_gnd)
        stance_tgt = torch.where(on_wall0[..., None], press_wall, stance_tgt)
        foot_tgt = torch.where(loaded[..., None] > 0.5, stance_tgt, foot_tgt)

        state_des = torch.cat([refs_z[:, 1, 0:3], refs_z[:, 1, 3:6],
                               foot_tgt.reshape(B, 12)], -1)
        vel_des = torch.cat([refs_z[:, 1, 6:9],
                             torch.zeros((B, 3), dtype=dtype, device=dev),
                             U[:, 0, 12:24]], -1)
        out = torch.cat([u, state_des, vel_des, state_des,
                         torch.zeros((B, 12), dtype=dtype, device=dev)], -1)
        return out, {"u": U, "valid": torch.ones((B,), dtype=dtype,
                                                 device=dev)}

    def policy(x, t, warm):
        out, w = batched(x[None], {k: v[None] for k, v in warm.items()})
        return out[0], {k: v[0] for k, v in w.items()}

    def warm_init(dtype=torch.float32, device="cuda"):
        device = resolve_device(device)
        return {"u": torch.zeros((horizon, NU), dtype=dtype, device=device),
                "valid": torch.zeros((), dtype=dtype, device=device)}

    policy.ci_stateful = True
    policy.warm_init = warm_init
    return policy
