"""Closed-form leg kinematics (`legged_mpc_control_tpu/models/kinematics.py`).

Leg chain in the body frame: hip roll q1 about +x at (ox, oy, 0), motor
offset d along y, thigh pitch q2 and calf pitch q3 about +y with lengths
lt and lc. `rho_fix = [ox, oy, d, lt, lc]` (reference: A1Kinematics.h:21-25).

    x = ox - lt sin q2 - lc sin(q2+q3)
    y = oy + d cos q1 + sin q1 L
    z =      d sin q1 - cos q1 L,      L = lt cos q2 + lc cos(q2+q3)

Every function broadcasts over leading axes, so the 4-leg forms are the
same functions on (..., 4, 3) joints and (..., 4, 5) geometry.
"""

import torch


def _geom(rho_fix):
    return tuple(rho_fix[..., i] for i in range(5))


def fk(q, rho_fix):
    """Foot position in the body frame: q (..., 3) -> (..., 3)."""
    ox, oy, d, lt, lc = _geom(rho_fix)
    q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s2, c2 = torch.sin(q2), torch.cos(q2)
    s23, c23 = torch.sin(q2 + q3), torch.cos(q2 + q3)
    L = lt * c2 + lc * c23
    return torch.stack([ox - lt * s2 - lc * s23,
                        oy + d * c1 + s1 * L,
                        d * s1 - c1 * L], dim=-1)


def jac(q, rho_fix):
    """Foot Jacobian d(fk)/dq in the body frame: (..., 3, 3), closed form."""
    _, _, d, lt, lc = _geom(rho_fix)
    q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s2, c2 = torch.sin(q2), torch.cos(q2)
    s23, c23 = torch.sin(q2 + q3), torch.cos(q2 + q3)
    L = lt * c2 + lc * c23
    zero = torch.zeros_like(q1)
    dx = torch.stack([zero, -lt * c2 - lc * c23, -lc * c23], dim=-1)
    dy = torch.stack([-d * s1 + c1 * L, s1 * (-lt * s2 - lc * s23),
                      s1 * (-lc * s23)], dim=-1)
    dz = torch.stack([d * c1 + s1 * L, -c1 * (-lt * s2 - lc * s23),
                      -c1 * (-lc * s23)], dim=-1)
    return torch.stack([dx, dy, dz], dim=-2)


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def ik(p, q_ref, rho_fix):
    """Analytic IK, the branch nearest `q_ref` (reference:
    A1Kinematics.cpp:330-446). Out-of-reach targets clamp cos q3 to
    [-1, 1], so the result is always finite. p, q_ref (..., 3)."""
    ox, oy, d, lt, lc = _geom(rho_fix)
    px = p[..., 0] - ox
    py = p[..., 1] - oy
    pz = p[..., 2]
    L = torch.sqrt(torch.clamp(py * py + pz * pz - d * d, min=1e-12))
    c3 = torch.clamp((px * px + L * L - lt * lt - lc * lc) / (2.0 * lt * lc),
                     -1.0, 1.0)
    q3_mag = torch.arccos(c3)

    def candidate(L_signed, q3):
        q1 = _wrap(torch.atan2(pz, py) - torch.atan2(-L_signed, d))
        q2 = _wrap(torch.atan2(-px, L_signed)
                   - torch.atan2(lc * torch.sin(q3), lt + lc * torch.cos(q3)))
        return torch.stack([q1, q2, q3], dim=-1)

    best, best_d = None, None
    for L_signed in (L, -L):
        for q3 in (-q3_mag, q3_mag):
            c = candidate(L_signed, q3)
            dc = (_wrap(c - q_ref) ** 2).sum(dim=-1)
            if best is None:
                best, best_d = c, dc
            else:
                take = dc < best_d
                best = torch.where(take[..., None], c, best)
                best_d = torch.where(take, dc, best_d)
    return best


# --- calibration surface (reference: A1Kinematics.h:21-35) ---
# rho_opt = (cx, cy, cz): the foot-contact offset in the CALF frame; the
# reference's generated d_fk_dc (A1Kinematics.cpp autoFunc_d_fk_dc) is
# exactly Rx(q1) Ry(q2+q3), the calf-frame rotation. Where the reference
# carries MATLAB-generated closed forms of the calibration derivatives,
# these are torch.func.jacfwd of one FK, vmapped over the leading axes.


def _calf_rot(q):
    """Body-from-calf rotation Rx(q1) Ry(q2+q3): q (..., 3) -> (..., 3, 3)."""
    q1, q23 = q[..., 0], q[..., 1] + q[..., 2]
    s1, c1 = torch.sin(q1), torch.cos(q1)
    s, c = torch.sin(q23), torch.cos(q23)
    zero = torch.zeros_like(q1)
    return torch.stack([torch.stack([c, zero, s], dim=-1),
                        torch.stack([s1 * s, c1, -s1 * c], dim=-1),
                        torch.stack([-c1 * s, s1, c1 * c], dim=-1)], dim=-2)


def fk_cal(q, rho_opt, rho_fix):
    """FK with the calf-frame contact offset rho_opt (..., 3) (reference fk
    with rho_opt): (..., 3)."""
    return fk(q, rho_fix) + (_calf_rot(q) @ rho_opt[..., None])[..., 0]


def _per_leg(fn, q, rho_opt, rho_fix):
    """fn of one leg's (q (3,), rho_opt (3,), rho_fix (5,)) over the
    broadcast leading axes of the three, through torch.func.vmap."""
    lead = torch.broadcast_shapes(q.shape[:-1], rho_opt.shape[:-1],
                                  rho_fix.shape[:-1])
    args = [x.expand(lead + x.shape[-1:]).reshape((-1,) + x.shape[-1:])
            for x in (q, rho_opt, rho_fix)]
    out = torch.func.vmap(fn)(*args)
    return out.reshape(lead + out.shape[1:])


def _jac_cal1(q, rho_opt, rho_fix):
    return torch.func.jacfwd(fk_cal)(q, rho_opt, rho_fix)


def jac_cal(q, rho_opt, rho_fix):
    """d fk_cal / d q (..., 3, 3) (reference jac with rho_opt)."""
    return _per_leg(_jac_cal1, q, rho_opt, rho_fix)


def dfk_drho(q, rho_opt, rho_fix):
    """d fk / d rho_opt (..., 3, 3) (reference dfk_drho =
    autoFunc_d_fk_dc)."""
    return _per_leg(torch.func.jacfwd(fk_cal, argnums=1), q, rho_opt,
                    rho_fix)


def dJ_dq(q, rho_opt, rho_fix):
    """d vec(J) / d q (..., 9, 3), vec row-major over J's (row, col)
    (reference dJ_dq, in this 9x3 layout rather than Eigen's)."""
    full = _per_leg(torch.func.jacfwd(_jac_cal1), q, rho_opt, rho_fix)
    return full.reshape(full.shape[:-3] + (9, 3))


def dJ_drho(q, rho_opt, rho_fix):
    """d vec(J) / d rho_opt (..., 9, 3) (reference dJ_drho)."""
    full = _per_leg(torch.func.jacfwd(_jac_cal1, argnums=1), q, rho_opt,
                    rho_fix)
    return full.reshape(full.shape[:-3] + (9, 3))


fk_legs = fk      # (..., 4, 3), (..., 4, 5) -> (..., 4, 3)
jac_legs = jac    # -> (..., 4, 3, 3)
ik_legs = ik      # -> (..., 4, 3)
