"""Floating-base whole-body dynamics of A1/Go1-class quadrupeds
(`legged_mpc_control_tpu/models/whole_body.py`), derived by automatic
differentiation from one forward-kinematics function with `torch.func`: the
kinetic energy is evaluated exactly with `jvp` through FK, the mass matrix
is its velocity Hessian, and the bias forces follow from the Euler-Lagrange
identity

    nle(q, v) = d/dt (M v) - grad_q KE + grad_q PE .

Generalized coordinates q (18,) = [base pos(3), euler ZYX (yaw, pitch,
roll), joint angles (12, FL, FR, RL, RR x HAA, HFE, KFE)], v = dq/dt
(reference: BaseInterface.cpp:512-518). Link masses, COMs and inertias
follow the A1 and Go1 URDFs (reference: urdf/*/const.xacro).

The public functions are batch-first (q, v (B, 18)). The FK is written
over leading axes; the derivatives run per scenario under `vmap`.
`models/whole_body_b.py` computes the same quantities analytically; the
simulator and the WBC use that one.
"""

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import grad, jacfwd, jvp, vmap

from legged_mpc_control_tpu_torch.config import resolve_device
from legged_mpc_control_tpu_torch.constants import GRAVITY_EST
from legged_mpc_control_tpu_torch.tree import Struct, from_numpy

N_Q = 18
N_JOINTS = 12
# URDF leg geometry (A1 const.xacro): the dynamics model uses the URDF's
# 0.2 m thigh and calf, the controller's kinematics the reference's 0.21 m
LEG_OFFSET_X = 0.1805
LEG_OFFSET_Y = 0.047
THIGH_OFFSET = 0.0838
THIGH_LEN = 0.2
CALF_LEN = 0.2


@dataclass
class WbModel(Struct):
    """Constant model data, tensors of one dtype on one device."""
    trunk_mass: torch.Tensor        # scalar
    trunk_com: torch.Tensor         # (3,)
    trunk_inertia: torch.Tensor     # (3,3) about COM, trunk frame
    hip_origin: torch.Tensor        # (4,3) in trunk frame
    hfe_origin: torch.Tensor        # (4,3) in hip frame
    kfe_origin: torch.Tensor        # (4,3) in thigh frame
    foot_origin: torch.Tensor       # (4,3) in calf frame
    link_mass: torch.Tensor         # (4,3) hip/thigh/calf(+foot lumped)
    link_com: torch.Tensor          # (4,3,3) COM in link frame
    link_inertia: torch.Tensor      # (4,3,3,3) about COM, link frame


def _mirrored_inertia(ixx, ixy, ixz, iyy, iyz, izz, mirror, front):
    return np.array([
        [ixx, ixy * mirror * front, ixz * front],
        [ixy * mirror * front, iyy, iyz * mirror],
        [ixz * front, iyz * mirror, izz],
    ])


def _shift(I, mass, r):
    """Parallel-axis shift of inertia I of `mass` by offset r."""
    r = np.asarray(r)
    return I + mass * (np.dot(r, r) * np.eye(3) - np.outer(r, r))


def _to_model(arrays: dict, dtype, device) -> WbModel:
    device = resolve_device(device)
    return WbModel(**{k: torch.as_tensor(np.asarray(v, dtype=np.float64),
                                         dtype=dtype, device=device)
                      for k, v in arrays.items()})


def a1_wb_model(dtype=torch.float32, device="cuda") -> WbModel:
    """A1 link parameters. reference: urdf/a1/const.xacro; the 0.06 kg foot
    lumped into the calf as a point mass at the foot."""
    mirrors = [1.0, -1.0, 1.0, -1.0]       # FL, FR, RL, RR
    fronts = [1.0, 1.0, -1.0, -1.0]
    hip_origin, hfe_origin = [], []
    link_com, link_inertia, link_mass = [], [], []
    for m, f in zip(mirrors, fronts):
        hip_origin.append([LEG_OFFSET_X * f, LEG_OFFSET_Y * m, 0.0])
        hfe_origin.append([0.0, THIGH_OFFSET * m, 0.0])
        hip_com = [-0.003875 * f, 0.001622 * m, 0.000042]
        thigh_com = [-0.003574, -0.019529 * m, -0.030323]
        calf_m, foot_m = 0.151, 0.06
        calf_com_own = np.array([0.007105, -0.000239 * m, -0.096933])
        foot_pos = np.array([0.0, 0.0, -CALF_LEN])
        lumped_m = calf_m + foot_m
        calf_com = (calf_m * calf_com_own + foot_m * foot_pos) / lumped_m
        link_com.append([hip_com, thigh_com, list(calf_com)])
        link_mass.append([0.595, 0.888, lumped_m])
        hip_I = _mirrored_inertia(0.000402747, -0.000008709, -0.000000297,
                                  0.000691123, -0.000000545, 0.000487919,
                                  m, f)
        thigh_I = _mirrored_inertia(0.005251806, -0.000002168, 0.000346889,
                                    0.005000475, -0.000028174, 0.001110200,
                                    m, 1.0)
        calf_I_own = _mirrored_inertia(0.002344758, 0.0, -0.000141275,
                                       0.002360755, 0.0, 0.000031158,
                                       m, 1.0)
        calf_I = (_shift(calf_I_own, calf_m, calf_com_own - calf_com)
                  + _shift(np.zeros((3, 3)), foot_m, foot_pos - calf_com))
        link_inertia.append([hip_I, thigh_I, calf_I])
    return _to_model(dict(
        trunk_mass=6.0,
        trunk_com=[0.0, 0.0041, -0.0005],
        trunk_inertia=[[0.0158533, -0.0000366, -0.0000611],
                       [-0.0000366, 0.0377999, -0.0000275],
                       [-0.0000611, -0.0000275, 0.0456542]],
        hip_origin=hip_origin, hfe_origin=hfe_origin,
        kfe_origin=np.tile([0.0, 0.0, -THIGH_LEN], (4, 1)),
        foot_origin=np.tile([0.0, 0.0, -CALF_LEN], (4, 1)),
        link_mass=link_mass, link_com=link_com, link_inertia=link_inertia),
        dtype, device)


def go1_wb_model(dtype=torch.float32, device="cuda") -> WbModel:
    """Go1 link parameters. reference: urdf/go1_description/xacro/
    const.xacro with the mirroring of xacro/leg.xacro:48-171; the 0.06 kg
    foot sphere lumped into the calf. Geometry: leg_offset (0.1881,
    0.04675), thigh_offset 0.08, thigh/calf length 0.213."""
    mirrors = [1.0, -1.0, 1.0, -1.0]
    fronts = [1.0, 1.0, -1.0, -1.0]
    leg_off_x, leg_off_y = 0.1881, 0.04675
    thigh_off, thigh_len, calf_len = 0.08, 0.213, 0.213
    hip_origin, hfe_origin = [], []
    link_com, link_inertia, link_mass = [], [], []
    for m, f in zip(mirrors, fronts):
        hip_origin.append([leg_off_x * f, leg_off_y * m, 0.0])
        hfe_origin.append([0.0, thigh_off * m, 0.0])
        hip_com = [-0.00541 * f, -0.00074 * m, 0.000006]
        thigh_com = [-0.003468, -0.018947 * m, -0.032736]
        calf_m, foot_m = 0.131, 0.06
        calf_com_own = np.array([0.006286, 0.001307, -0.122269])
        foot_pos = np.array([0.0, 0.0, -calf_len])
        lumped_m = calf_m + foot_m
        calf_com = (calf_m * calf_com_own + foot_m * foot_pos) / lumped_m
        link_com.append([hip_com, thigh_com, list(calf_com)])
        link_mass.append([0.591, 0.92, lumped_m])
        hip_I = _mirrored_inertia(0.000374268192, 0.000036844422,
                                  -0.000000986754, 0.000635923669,
                                  -0.000001172894, 0.000457647394, m, f)
        thigh_I = _mirrored_inertia(0.005851561134, 0.000001783284,
                                    0.000328291374, 0.005596155105,
                                    0.000021430713, 0.00107157026, m, 1.0)
        calf_I_own = _mirrored_inertia(0.002939186297, 0.000001440899,
                                       -0.000105359550, 0.00295576935,
                                       -0.000024397752, 0.000030273372,
                                       1.0, 1.0)
        # foot sphere's own inertia 2/5 m r^2 (leg.xacro:168-170)
        foot_I = np.eye(3) * (0.4 * foot_m * 0.02 ** 2)
        calf_I = (_shift(calf_I_own, calf_m, calf_com_own - calf_com)
                  + _shift(foot_I, foot_m, foot_pos - calf_com))
        link_inertia.append([hip_I, thigh_I, calf_I])
    return _to_model(dict(
        trunk_mass=5.204,
        trunk_com=[0.0223, 0.002, -0.0005],
        trunk_inertia=[[0.0168352186, 0.0004636141, 0.0002367952],
                       [0.0004636141, 0.0656071082, 0.000036671],
                       [0.0002367952, 0.000036671, 0.0742720659]],
        hip_origin=hip_origin, hfe_origin=hfe_origin,
        kfe_origin=np.tile([0.0, 0.0, -thigh_len], (4, 1)),
        foot_origin=np.tile([0.0, 0.0, -calf_len], (4, 1)),
        link_mass=link_mass, link_com=link_com, link_inertia=link_inertia),
        dtype, device)


def wb_model_for(robot: str, dtype=torch.float32, device="cuda") -> WbModel:
    """Whole-body model by robot name (reference: main.cpp:36-44)."""
    if robot == "a1":
        return a1_wb_model(dtype, device)
    if robot == "go1":
        return go1_wb_model(dtype, device)
    raise ValueError(f"unknown robot {robot!r}")


def wb_model_from_numpy(tree, dtype=None, device=None) -> WbModel:
    """A WbModel from arrays keyed by field name: a JAX `WbModel` (its
    numpy fields), or `tree.to_numpy` of a port model. dtype: cast every
    leaf (None keeps the arrays' own)."""
    m = from_numpy(WbModel, tree, device)
    return m if dtype is None else m.replace(
        **{k: v.to(dtype) for k, v in vars(m).items()})


def _m(x, like):
    """A model tensor in the dtype of `like` (free when they agree)."""
    return x.to(like.dtype)


def _rot(axis, a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    rows = {"x": [[o, z, z], [z, c, -s], [z, s, c]],
            "y": [[c, z, s], [z, o, z], [-s, z, c]],
            "z": [[c, -s, z], [s, c, z], [z, z, o]]}[axis]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def base_rot(q):
    """World-from-base rotation from ZYX euler (yaw, pitch, roll): q
    (..., 18) -> (..., 3, 3)."""
    return _rot("z", q[..., 3]) @ _rot("y", q[..., 4]) @ _rot("x", q[..., 5])


def _mv(R, p):
    return (R @ p[..., None])[..., 0]


def body_frames(q, model: WbModel):
    """World rotation and world COM position of the 13 bodies (trunk, then
    per leg hip, thigh, calf) and the four feet: q (..., 18) ->
    (R (..., 13, 3, 3), p_com (..., 13, 3), p_foot (..., 4, 3))."""
    pos = q[..., 0:3]
    Rb = base_rot(q)
    Rs = [Rb]
    ps = [pos + _mv(Rb, _m(model.trunk_com, q))]
    feet = []
    for leg in range(4):
        qj = q[..., 6 + 3 * leg:9 + 3 * leg]
        R_hip = Rb @ _rot("x", qj[..., 0])
        p_hip_j = pos + _mv(Rb, _m(model.hip_origin[leg], q))
        R_thigh = R_hip @ _rot("y", qj[..., 1])
        p_hfe = p_hip_j + _mv(R_hip, _m(model.hfe_origin[leg], q))
        R_calf = R_thigh @ _rot("y", qj[..., 2])
        p_kfe = p_hfe + _mv(R_thigh, _m(model.kfe_origin[leg], q))
        feet.append(p_kfe + _mv(R_calf, _m(model.foot_origin[leg], q)))
        for R_l, p_j, ci in ((R_hip, p_hip_j, 0), (R_thigh, p_hfe, 1),
                             (R_calf, p_kfe, 2)):
            Rs.append(R_l)
            ps.append(p_j + _mv(R_l, _m(model.link_com[leg, ci], q)))
    return torch.stack(Rs, -3), torch.stack(ps, -2), torch.stack(feet, -2)


def _masses_inertias(model: WbModel, like):
    masses = torch.cat([_m(model.trunk_mass, like)[None],
                        _m(model.link_mass, like).reshape(-1)])
    inertias = torch.cat([_m(model.trunk_inertia, like)[None],
                          _m(model.link_inertia, like).reshape(-1, 3, 3)])
    return masses, inertias


def kinetic_energy(q, v, model: WbModel):
    """Exact kinetic energy via `jvp` through FK (angular velocity from
    R_dot R^T): q, v (..., 18) -> (...)."""
    masses, inertias = _masses_inertias(model, q)
    (R, p), (dR, dp) = jvp(lambda qq: body_frames(qq, model)[:2], (q,), (v,))
    W = dR @ R.transpose(-1, -2)
    omega = torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)
    I_world = R @ inertias @ R.transpose(-1, -2)
    ke_lin = 0.5 * (masses * (dp * dp).sum(-1)).sum(-1)
    ke_ang = 0.5 * (omega * _mv(I_world, omega)).sum((-1, -2))
    return ke_lin + ke_ang


def potential_energy(q, model: WbModel):
    masses, _ = _masses_inertias(model, q)
    _, p, _ = body_frames(q, model)
    return GRAVITY_EST * (masses * p[..., 2]).sum(-1)


def mass_matrix(q, model: WbModel):
    """M(q) (B, 18, 18): the velocity Hessian of the kinetic energy."""
    def one(qq):
        return jacfwd(grad(lambda vv: kinetic_energy(qq, vv, model)))(
            torch.zeros_like(qq))
    return vmap(one)(q)


def nonlinear_effects(q, v, model: WbModel):
    """nle(q, v) = C(q, v) v + g(q) (B, 18), by the Euler-Lagrange
    identity."""
    def one(qq, vv):
        def mom(q1):
            return grad(lambda v1: kinetic_energy(q1, v1, model))(vv)
        _, dmom = jvp(mom, (qq,), (vv,))                 # d/dt (M v)
        dke_dq = grad(lambda q1: kinetic_energy(q1, vv, model))(qq)
        dpe_dq = grad(lambda q1: potential_energy(q1, model))(qq)
        return dmom - dke_dq + dpe_dq
    return vmap(one)(q, v)


def foot_positions(q, model: WbModel):
    """World foot positions (..., 4, 3)."""
    return body_frames(q, model)[2]


def foot_jacobians(q, model: WbModel):
    """J (B, 4, 3, 18): world foot velocity = J v."""
    return vmap(jacfwd(lambda qq: foot_positions(qq, model)))(q)


def foot_jdot_v(q, v, model: WbModel):
    """Jdot(q, v) v (B, 4, 3), the drift term of the contact constraint."""
    def one(qq, vv):
        def jv(q1):
            return jacfwd(lambda q2: foot_positions(q2, model))(q1) @ vv
        return jvp(jv, (qq,), (vv,))[1]
    return vmap(one)(q, v)


def com_position(q, model: WbModel):
    """Whole-body center of mass (..., 3)."""
    masses, _ = _masses_inertias(model, q)
    _, p, _ = body_frames(q, model)
    return (masses[:, None] * p).sum(-2) / masses.sum()
