"""Articulated whole-body simulator (`legged_mpc_control_tpu/sim/wb_sim.py`),
the Gazebo-fidelity twin (reference: GazeboInterface.cpp:99-118): 18-DoF
floating-base dynamics under per-joint torques, with compliant ground (and
optional wall) contact. Batch-first: every state leaf carries a leading
scenario axis; a single robot is a batch of one.

Dynamics:  M(q) a = S^T tau + sum_l J_l^T f_l - nle(q, v)
with M, nle and J from the analytic batched CRBA/RNEA
(`models/whole_body_b.py`, pinned to the autodiff model), plus actuator
armature and viscous joint friction; semi-implicit Euler with `n_inner`
inner steps a control period. The mass matrices (SPD: CRBA + armature) are
factored and solved in one batched call each: kernels K4 + K5
(`ops/chol_kernel.py`) on CUDA tensors, at n = 18 unpadded; their plain
versions on CPU tensors.

Contact (per foot, world frame): a normal spring-damper on the terrain
penetration, fn = max(0, KP_N d - KD_N vz); tangential stiction spring to
an anchor with a Coulomb cap |ft| <= mu fn, the anchor dragged so that the
spring sustains exactly the capped force while sliding. A `Wall` gets the
same model rotated onto its plane. Torques saturate at +-33.5 Nm
(reference: task.info:228-230).
"""

from dataclasses import dataclass

import torch

from legged_mpc_control_tpu_torch.config import RobotParams, resolve_device
from legged_mpc_control_tpu_torch.constants import GRAVITY_EST
from legged_mpc_control_tpu_torch.models import kinematics as kin
from legged_mpc_control_tpu_torch.models import whole_body as wb
from legged_mpc_control_tpu_torch.models import whole_body_b as wbb
from legged_mpc_control_tpu_torch.ops import chol_kernel, so3
from legged_mpc_control_tpu_torch.sim import terrain as terrain_mod
from legged_mpc_control_tpu_torch.tree import Struct

# Contact compliance, sized to mimic Gazebo/ODE's near-rigid contact. The
# damping is integrated explicitly: the inner step must satisfy
# h < 2 m_eff / KD_N (~0.6 ms at the ~0.25 kg reflected foot mass); the
# default n_inner=4 (312 us) leaves a 2x margin.
KP_N = 40000.0      # N/m normal stiffness
KD_N = 800.0        # N s/m normal damping
KT = 20000.0        # N/m tangential (stiction) stiffness
KD_T = 400.0        # N s/m tangential damping
ARMATURE = 0.01     # kg m^2 reflected rotor inertia per joint
JOINT_DAMPING = 0.02  # N m s/rad viscous joint friction
TAU_MAX = 33.5      # N m actuator limit (reference: task.info:228-230)
CONTACT_SENSE_MIN = 1.0  # N: the sensor reports contact above this


@dataclass
class WbSimState(Struct):
    """Articulated world state, batch-first."""
    q: torch.Tensor            # (B,18) [base pos, euler ZYX, joints]
    v: torch.Tensor            # (B,18) dq/dt
    anchor: torch.Tensor       # (B,4,2) tangential anchors, world xy
    wall_anchor: torch.Tensor  # (B,4,3) stiction anchors on the wall plane
    f_contact: torch.Tensor    # (B,4,3) last contact forces, world
    last_acc: torch.Tensor     # (B,3) last world base acceleration


def wb_rho_fix(model: wb.WbModel, dtype=torch.float32):
    """The dynamics model's own leg geometry in kinematics form
    [ox, oy, d, lt, lc] per leg (4,5), for IK against the simulated robot
    (the controller keeps its own rho_fix)."""
    return torch.stack([model.hip_origin[:, 0], model.hip_origin[:, 1],
                        model.hfe_origin[:, 1], -model.kfe_origin[:, 2],
                        -model.foot_origin[:, 2]], -1).to(dtype)


def wb_sim_init(model: wb.WbModel, params: RobotParams, heights,
                dtype=torch.float32, device="cuda",
                terrain=None) -> WbSimState:
    """Standing start: trunk at `heights` (B,) above the ground under the
    origin, the default stance, feet resting on the ground."""
    device = resolve_device(device)
    heights = torch.as_tensor(heights, dtype=dtype, device=device)
    B = heights.shape[0]
    ground = torch.zeros((), dtype=dtype, device=device)
    if terrain is not None:
        ground = terrain_mod.height_at(
            terrain, torch.zeros(2, dtype=dtype, device=device))
    foot_rel = params.default_foot_pos.to(dtype).expand(B, 4, 3).clone()
    foot_rel[..., 2] = -heights[:, None]
    q_guess = torch.tensor([0.0, 0.8, -1.6], dtype=dtype,
                           device=device).expand(B, 4, 3)
    qj = kin.ik_legs(foot_rel, q_guess, wb_rho_fix(model, dtype))
    q = torch.zeros((B, 18), dtype=dtype, device=device)
    q[:, 2] = heights + ground
    q[:, 6:] = qj.reshape(B, 12)
    feet = wb.foot_positions(q, model)
    return WbSimState(
        q=q, v=torch.zeros_like(q), anchor=feet[..., :2].clone(),
        wall_anchor=feet, f_contact=torch.zeros_like(feet),
        last_acc=torch.zeros((B, 3), dtype=dtype, device=device))


def _capped(fs, fn, mu):
    """Tangential force fs (B,4,k) scaled into the cone |ft| <= mu fn."""
    cap = mu[:, None] * fn
    norm = torch.sqrt((fs * fs).sum(-1) + 1e-12)
    return fs * torch.clamp(cap / norm, max=1.0)[..., None]


def _contact_forces(feet, vfeet, anchor, mu, terrain):
    """Compliant ground reaction per foot: feet, vfeet (B,4,3), anchor
    (B,4,2), mu (B,). Returns (f (B,4,3), anchor')."""
    if terrain is not None:
        ground = terrain_mod.height_at(terrain, feet[..., :2])
    else:
        ground = torch.zeros_like(feet[..., 2])
    d = ground - feet[..., 2]                        # penetration depth
    in_contact = d > 0.0
    fn = torch.clamp(KP_N * d - KD_N * vfeet[..., 2], min=0.0)
    fn = torch.where(in_contact, fn, torch.zeros_like(fn))
    fs = -KT * (feet[..., :2] - anchor) - KD_T * vfeet[..., :2]
    ft = _capped(fs, fn, mu)
    # drag the anchor so the spring sustains exactly the capped force;
    # unsaturated, anchor' == anchor
    a_contact = feet[..., :2] + (ft + KD_T * vfeet[..., :2]) / KT
    anchor = torch.where(in_contact[..., None], a_contact, feet[..., :2])
    return torch.cat([ft, fn[..., None]], -1), anchor


def _wall_contact_forces(feet, vfeet, wall_anchor, mu, wall):
    """Compliant wall reaction per foot: `_contact_forces`' model rotated
    onto the wall plane (normal along wall.normal, the stiction spring in
    the plane, which lets a foot pressed against a vertical wall carry
    vertical load through friction). Returns (f (B,4,3), wall_anchor')."""
    n = wall.normal.to(feet.dtype)
    d = -terrain_mod.wall_gap(wall, feet)            # penetration depth
    in_contact = d > 0.0
    vn = (vfeet * n).sum(-1)
    fn = torch.clamp(KP_N * d - KD_N * vn, min=0.0)
    fn = torch.where(in_contact, fn, torch.zeros_like(fn))
    pt = feet - (feet * n).sum(-1, keepdim=True) * n
    at = wall_anchor - (wall_anchor * n).sum(-1, keepdim=True) * n
    vt = vfeet - vn[..., None] * n
    fs = -KT * (pt - at) - KD_T * vt
    ft = _capped(fs, fn, mu)
    a_contact = pt + (ft + KD_T * vt) / KT
    wall_anchor = torch.where(in_contact[..., None], a_contact, pt)
    return ft + fn[..., None] * n, wall_anchor


def wb_sim_step_batched(s: WbSimState, tau, model: wb.WbModel,
                        params: RobotParams, dt, *, n_inner: int = 4,
                        terrain=None, wall=None) -> WbSimState:
    """Advance the batch by `dt` under joint torques tau (B,12) in
    `n_inner` semi-implicit inner steps. `params` batched (its mu (B,) is
    read); `model`, `terrain` and `wall` shared. The mass-matrix solve is
    K4 + K5 on CUDA tensors (float32; anything else raises) and their plain
    versions on CPU tensors."""
    h = dt / n_inner
    tau_c = torch.clamp(tau, -TAU_MAX, TAU_MAX)
    mu = params.mu.to(s.q.dtype)
    arma = torch.zeros(18, dtype=s.q.dtype, device=s.q.device)
    arma[6:] = ARMATURE
    arma = torch.diag(arma)
    q, v, anchor, wall_anchor = s.q, s.v, s.anchor, s.wall_anchor
    for _ in range(n_inner):
        M, nle, J, feet = wbb.dyn_terms_b(q, v, model)
        M = M + arma
        vfeet = (J @ v[:, None, :, None])[..., 0]
        f, anchor = _contact_forces(feet, vfeet, anchor, mu, terrain)
        if wall is not None:
            fw, wall_anchor = _wall_contact_forces(feet, vfeet, wall_anchor,
                                                   mu, wall)
            f = f + fw
        gen = torch.cat([-nle[:, :6],
                         -nle[:, 6:] + (tau_c - JOINT_DAMPING * v[:, 6:])],
                        -1)
        gen = gen + torch.einsum("blij,bli->bj", J, f)
        a = chol_kernel.cho_solve_cuda(chol_kernel.cholesky_cuda(M), gen)
        v = v + a * h
        q = q + v * h
    return WbSimState(q=q, v=v, anchor=anchor, wall_anchor=wall_anchor,
                      f_contact=f, last_acc=a[:, :3])


def wb_sim_step(s: WbSimState, tau, model: wb.WbModel, params: RobotParams,
                dt, *, n_inner: int = 4, terrain=None,
                wall=None) -> WbSimState:
    """One robot's step: `wb_sim_step_batched` on a batch of one (its
    leaves carry a leading axis of 1; `params` shared or batched by one)."""
    from legged_mpc_control_tpu_torch.control.step import broadcast_params

    return wb_sim_step_batched(s, tau, model, broadcast_params(params, 1),
                               dt, n_inner=n_inner, terrain=terrain,
                               wall=wall)


def wb_read_sensors(s: WbSimState, model: wb.WbModel = None) -> dict:
    """Raw proprioception, the contract of `srb_sim.read_sensors`, with the
    foot force sensor fed by the physical contact normal force (the
    world-z component, as the A1's sole sensor reads: a foot pressed
    against a vertical wall reads ~0). `model` is not read (the JAX
    package's signature): the angular velocity is the euler-rate map's."""
    q, v = s.q, s.v
    R, E = wbb.base_rot_rates(q)
    omega = (E @ v[:, 3:6, None])[..., 0]
    euler_rpy = torch.stack([q[:, 5], q[:, 4], q[:, 3]], -1)
    acc = torch.cat([s.last_acc[:, :2], s.last_acc[:, 2:] + GRAVITY_EST], -1)
    Rt = R.transpose(-1, -2)
    fz = s.f_contact[..., 2]
    return dict(
        quat=so3.euler_to_quat(euler_rpy), pos=q[:, 0:3], vel=v[:, 0:3],
        imu_acc=(Rt @ acc[..., None])[..., 0],
        imu_ang_vel=(Rt @ omega[..., None])[..., 0],
        joint_pos=q[:, 6:18], joint_vel=v[:, 6:18],
        foot_force_sensor=fz, contact=fz > CONTACT_SENSE_MIN)
