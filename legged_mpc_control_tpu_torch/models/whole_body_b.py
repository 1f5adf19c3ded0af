"""Batched analytic floating-base dynamics of the articulated simulator
(`legged_mpc_control_tpu/models/whole_body_b.py`): the hand-structured
equivalent of the autodiff model (`models/whole_body.py`), as the
reference takes M, nle and J from Pinocchio's CRBA/RNEA (wbc.cpp:59-91).
One leg-vectorized FK pass, then

  * M(q): composite over the 13 bodies, M = sum_b m_b Jv_b^T Jv_b
    + Jw_b^T I_b^w Jw_b with analytic body Jacobians (base columns from the
    ZYX euler-rate matrix E, joint columns from world joint axes x lever
    arms);
  * nle: the recursive Newton-Euler bias sweep with qdd = 0 (including the
    Edot erate term of the euler-rate parameterization), the per-body bias
    wrenches mapped back through the same Jacobians;
  * J_feet: the foot-point Jacobian of the same structure.

Batch-first: q, v (B, 18), same coordinates as the autodiff model.
"""

from dataclasses import dataclass

import torch

from legged_mpc_control_tpu_torch.constants import GRAVITY_EST
from legged_mpc_control_tpu_torch.models.whole_body import WbModel, _rot


def _cross(a, b):
    return torch.linalg.cross(a, b)


@dataclass
class _Fk:
    """Leg-vectorized FK products (B batch, 4 legs)."""
    pos: torch.Tensor        # (B,3) base origin
    Rb: torch.Tensor         # (B,3,3)
    E: torch.Tensor          # (B,3,3) euler-rate matrix: omega = E erate
    R_hip: torch.Tensor      # (B,4,3,3)
    R_thigh: torch.Tensor
    R_calf: torch.Tensor
    p_hipj: torch.Tensor     # (B,4,3) joint positions, world
    p_hfe: torch.Tensor
    p_kfe: torch.Tensor
    p_foot: torch.Tensor
    a1: torch.Tensor         # (B,4,3) world joint axes
    a2: torch.Tensor
    a3: torch.Tensor
    c_trunk: torch.Tensor    # (B,3) trunk COM, world
    c_hip: torch.Tensor      # (B,4,3) link COMs, world
    c_thigh: torch.Tensor
    c_calf: torch.Tensor


def base_rot_rates(q):
    """The base rotation Rb (B,3,3) and the ZYX euler-rate matrix E
    (B,3,3), omega_world = E erate = psi_dot z + theta_dot Rz y
    + phi_dot Rz Ry x."""
    Rz, Ry, Rx = _rot("z", q[:, 3]), _rot("y", q[:, 4]), _rot("x", q[:, 5])
    RzRy = Rz @ Ry
    ez = torch.zeros_like(q[:, 0:3])
    ez[:, 2] = 1.0
    return RzRy @ Rx, torch.stack([ez, Rz[:, :, 1], RzRy[:, :, 0]], -1)


def fk_b(q, model: WbModel) -> _Fk:
    """Batched FK of the 13-body tree. q (B, 18)."""
    def mdl(x):
        return x.to(q.dtype)
    pos = q[:, 0:3]
    Rb, E = base_rot_rates(q)

    qj = q[:, 6:18].reshape(-1, 4, 3)
    R_hip = Rb[:, None] @ _rot("x", qj[..., 0])
    R_thigh = R_hip @ _rot("y", qj[..., 1])
    R_calf = R_thigh @ _rot("y", qj[..., 2])

    def at(R, off):                     # R (B,[4,]3,3), off (4,3)
        return torch.einsum("...ij,...j->...i", R, mdl(off))
    p_hipj = pos[:, None] + torch.einsum("bij,lj->bli", Rb,
                                         mdl(model.hip_origin))
    p_hfe = p_hipj + at(R_hip, model.hfe_origin)
    p_kfe = p_hfe + at(R_thigh, model.kfe_origin)
    p_foot = p_kfe + at(R_calf, model.foot_origin)

    a1 = Rb[:, None, :, 0].expand(p_hipj.shape)     # base x axis
    a2 = R_hip[..., :, 1]                           # hip-frame y
    a3 = R_thigh[..., :, 1]                         # thigh-frame y

    lc = model.link_com
    c_trunk = pos + torch.einsum("bij,j->bi", Rb, mdl(model.trunk_com))
    c_hip = p_hipj + at(R_hip, lc[:, 0])
    c_thigh = p_hfe + at(R_thigh, lc[:, 1])
    c_calf = p_kfe + at(R_calf, lc[:, 2])
    return _Fk(pos, Rb, E, R_hip, R_thigh, R_calf, p_hipj, p_hfe, p_kfe,
               p_foot, a1, a2, a3, c_trunk, c_hip, c_thigh, c_calf)


def _leg_cols_to_12(blk):
    """(B,4,3,3) per-leg joint columns -> (B,4,3,12), block-diagonal in the
    leg index (leg l's columns at 3l..3l+2, the other legs' zero)."""
    eye4 = torch.eye(4, dtype=blk.dtype, device=blk.device)
    full = blk[:, :, :, None, :] * eye4[None, :, None, :, None]
    return full.reshape(blk.shape[0], 4, 3, 12)


def _point_jac(fk: _Fk, p, lever_joints):
    """Jacobian (B,4,3,18) of world points p (B,4,3) fixed in a leg body;
    lever_joints: [(axis (B,4,3), joint position (B,4,3))] along the
    chain."""
    B = p.shape[0]
    I3 = torch.eye(3, dtype=p.dtype, device=p.device).expand(B, 4, 3, 3)
    rel = p - fk.pos[:, None]
    Je = torch.stack([_cross(fk.E[:, None, :, k].expand(rel.shape), rel)
                      for k in range(3)], -1)
    cols = [_cross(a, p - pj) for a, pj in lever_joints]
    cols += [torch.zeros_like(p)] * (3 - len(cols))
    Jj = _leg_cols_to_12(torch.stack(cols, -1))
    return torch.cat([I3, Je, Jj], -1)


def _interleave(h, t, c):
    """(B,4,...) x3 -> (B,12,...) in body order hip, thigh, calf per leg."""
    return torch.stack([h, t, c], 2).reshape((h.shape[0], 12)
                                             + tuple(h.shape[2:]))


def _body_jacs(fk: _Fk):
    """Stacked linear and angular COM Jacobians of the 13 bodies:
    Jv, Jw (B,13,3,18)."""
    B = fk.pos.shape[0]
    dtype, dev = fk.pos.dtype, fk.pos.device
    zero4 = torch.zeros((B, 4, 3), dtype=dtype, device=dev)
    rel_t = fk.c_trunk - fk.pos
    Je_t = torch.stack([_cross(fk.E[:, :, k], rel_t) for k in range(3)], -1)
    Jv_trunk = torch.cat([
        torch.eye(3, dtype=dtype, device=dev).expand(B, 3, 3), Je_t,
        torch.zeros((B, 3, 12), dtype=dtype, device=dev)], -1)[:, None]
    Jw_trunk = torch.cat([
        torch.zeros((B, 3, 3), dtype=dtype, device=dev), fk.E,
        torch.zeros((B, 3, 12), dtype=dtype, device=dev)], -1)[:, None]
    chain = [(fk.a1, fk.p_hipj), (fk.a2, fk.p_hfe), (fk.a3, fk.p_kfe)]
    Jv_hip = _point_jac(fk, fk.c_hip, chain[:1])
    Jv_thigh = _point_jac(fk, fk.c_thigh, chain[:2])
    Jv_calf = _point_jac(fk, fk.c_calf, chain)

    def jw_leg(axes):
        cols = list(axes) + [zero4] * (3 - len(axes))
        Jj = _leg_cols_to_12(torch.stack(cols, -1))
        return torch.cat([torch.zeros((B, 4, 3, 3), dtype=dtype, device=dev),
                          fk.E[:, None].expand(B, 4, 3, 3), Jj], -1)
    Jw_hip = jw_leg([fk.a1])
    Jw_thigh = jw_leg([fk.a1, fk.a2])
    Jw_calf = jw_leg([fk.a1, fk.a2, fk.a3])
    Jv = torch.cat([Jv_trunk, _interleave(Jv_hip, Jv_thigh, Jv_calf)], 1)
    Jw = torch.cat([Jw_trunk, _interleave(Jw_hip, Jw_thigh, Jw_calf)], 1)
    return Jv, Jw


def _world_inertias(fk: _Fk, model: WbModel):
    """(B,13,3,3) world-frame body inertias about their COMs, and the (13,)
    masses, in trunk, then hip, thigh, calf per leg order."""
    dtype = fk.pos.dtype
    I_tr = fk.Rb @ model.trunk_inertia.to(dtype) @ fk.Rb.transpose(-1, -2)
    li = model.link_inertia.to(dtype)                    # (4,3,3,3)
    Iw = [R @ li[:, ci] @ R.transpose(-1, -2)
          for ci, R in ((0, fk.R_hip), (1, fk.R_thigh), (2, fk.R_calf))]
    Iw_all = torch.cat([I_tr[:, None], _interleave(*Iw)], 1)
    masses = torch.cat([model.trunk_mass.to(dtype)[None],
                        model.link_mass.to(dtype).reshape(-1)])
    return Iw_all, masses


def dyn_terms_b(q, v, model: WbModel):
    """All dynamics terms of the articulated step from one batched FK
    pass: (M (B,18,18), nle (B,18), J_feet (B,4,3,18), feet (B,4,3)), as
    `whole_body.mass_matrix`, `nonlinear_effects`, `foot_jacobians` and
    `foot_positions` compute them."""
    fk = fk_b(q, model)
    Jv, Jw = _body_jacs(fk)
    Iw, masses = _world_inertias(fk, model)

    # mass matrix: composite over the bodies
    M = (torch.einsum("n,bnik,bnil->bkl", masses, Jv, Jv)
         + torch.einsum("bnik,bnij,bnjl->bkl", Jw, Iw, Jw))

    # RNEA bias sweep (qdd = 0)
    erate = v[:, 3:6]
    dqj = v[:, 6:18].reshape(-1, 4, 3)
    w_base = torch.einsum("bij,bj->bi", fk.E, erate)
    # alpha_base = Edot erate:  d/dt E2 = psi_dot (E1 x E2),
    #   d/dt E3 = psi_dot (E1 x E3) + theta_dot (E2 x E3)
    E1, E2, E3 = fk.E[:, :, 0], fk.E[:, :, 1], fk.E[:, :, 2]
    psi_d, th_d, ph_d = erate[:, 0:1], erate[:, 1:2], erate[:, 2:3]
    al_base = (th_d * psi_d * _cross(E1, E2)
               + ph_d * (psi_d * _cross(E1, E3) + th_d * _cross(E2, E3)))

    wb4 = w_base[:, None].expand(q.shape[0], 4, 3)
    ab4 = al_base[:, None].expand(wb4.shape)
    w_hip = wb4 + fk.a1 * dqj[..., 0:1]
    al_hip = ab4 + _cross(wb4, fk.a1) * dqj[..., 0:1]
    w_thigh = w_hip + fk.a2 * dqj[..., 1:2]
    al_thigh = al_hip + _cross(w_hip, fk.a2) * dqj[..., 1:2]
    w_calf = w_thigh + fk.a3 * dqj[..., 2:3]
    al_calf = al_thigh + _cross(w_thigh, fk.a3) * dqj[..., 2:3]

    def pt_acc(a_ref, al, w, r):
        return a_ref + _cross(al, r) + _cross(w, _cross(w, r))

    a_hipj = pt_acc(0.0, ab4, wb4, fk.p_hipj - fk.pos[:, None])
    a_hfe = pt_acc(a_hipj, al_hip, w_hip, fk.p_hfe - fk.p_hipj)
    a_kfe = pt_acc(a_hfe, al_thigh, w_thigh, fk.p_kfe - fk.p_hfe)
    a_c_trunk = pt_acc(0.0, al_base, w_base, fk.c_trunk - fk.pos)
    a_c_hip = pt_acc(a_hipj, al_hip, w_hip, fk.c_hip - fk.p_hipj)
    a_c_thigh = pt_acc(a_hfe, al_thigh, w_thigh, fk.c_thigh - fk.p_hfe)
    a_c_calf = pt_acc(a_kfe, al_calf, w_calf, fk.c_calf - fk.p_kfe)

    def bodies(tr, h, t, c):
        return torch.cat([tr[:, None], _interleave(h, t, c)], 1)
    acc = bodies(a_c_trunk, a_c_hip, a_c_thigh, a_c_calf)
    wbod = bodies(w_base, w_hip, w_thigh, w_calf)
    albod = bodies(al_base, al_hip, al_thigh, al_calf)

    acc = torch.cat([acc[..., :2], acc[..., 2:] + GRAVITY_EST], -1)
    F = masses[None, :, None] * acc                          # (B,13,3)
    T = ((Iw @ albod[..., None])[..., 0]
         + _cross(wbod, (Iw @ wbod[..., None])[..., 0]))
    nle = (torch.einsum("bnik,bni->bk", Jv, F)
           + torch.einsum("bnik,bni->bk", Jw, T))
    return M, nle, _foot_jac(fk), fk.p_foot


def _foot_jac(fk: _Fk):
    return _point_jac(fk, fk.p_foot, [(fk.a1, fk.p_hipj), (fk.a2, fk.p_hfe),
                                      (fk.a3, fk.p_kfe)])


def mass_matrix_b(q, model: WbModel):
    return dyn_terms_b(q, torch.zeros_like(q), model)[0]


def nonlinear_effects_b(q, v, model: WbModel):
    return dyn_terms_b(q, v, model)[1]


def foot_jacobians_b(q, model: WbModel):
    return _foot_jac(fk_b(q, model))


def foot_positions_b(q, model: WbModel):
    return fk_b(q, model).p_foot
