"""Single-rigid-body simulator (`legged_mpc_control_tpu/sim/srb_sim.py`),
the stand-in for the reference's Gazebo twin, on flat ground or a height
field (`sim/terrain.py`). Batch-first.

Rigid trunk, massless legs, quasi-static contact:
  * commanded torques map to world foot forces F = -R J^-T tau, projected
    into the friction pyramid;
  * stance feet are anchored where they touch down and their joints follow
    from IK of the anchor; contact releases when the commanded normal force
    drops below CONTACT_RELEASE_FZ;
  * swing legs integrate light second-order joint dynamics;
  * the IMU reads specific force R^T (v_dot + g) and body angular velocity.
"""

import functools
from dataclasses import dataclass

import torch

from legged_mpc_control_tpu_torch.config import RobotParams, resolve_device
from legged_mpc_control_tpu_torch.constants import GRAVITY_EST
from legged_mpc_control_tpu_torch.models import kinematics as kin
from legged_mpc_control_tpu_torch.ops import la3, so3
from legged_mpc_control_tpu_torch.sim import terrain as terrain_mod
from legged_mpc_control_tpu_torch.tree import Struct

LEG_INERTIA = 0.04        # effective per-joint inertia of a light leg, kg m^2
LEG_DAMPING = 0.05        # viscous joint damping, N m s/rad
CONTACT_RELEASE_FZ = 1.0  # N: release the anchor below this support


@functools.lru_cache(maxsize=None)
def _gravity(dtype, device, sign):
    """[0, 0, sign * g] on `device`, built once: a tensor made from a list
    at every call is a host-to-device copy that waits for queued work."""
    return torch.tensor([0.0, 0.0, sign * GRAVITY_EST], dtype=dtype,
                        device=device)


@dataclass
class SimState(Struct):
    pos: torch.Tensor        # (B,3) trunk CoM, world
    quat: torch.Tensor       # (B,4) [w,x,y,z]
    vel: torch.Tensor        # (B,3) world
    omega: torch.Tensor      # (B,3) world angular velocity
    q: torch.Tensor          # (B,12) joint angles
    dq: torch.Tensor         # (B,12)
    contact: torch.Tensor    # (B,4) bool: leg anchored
    anchor: torch.Tensor     # (B,4,3) world anchors of the stance feet
    last_acc: torch.Tensor   # (B,3) world linear acceleration (IMU model)


def sim_init(params: RobotParams, heights, dtype=torch.float32,
             device="cuda", terrain=None) -> SimState:
    """Standing start: trunk at `heights` (B,) above the ground under the
    origin, feet at the default stance under the hips, anchored on the
    ground (flat, or the `terrain` height field). `params` unbatched."""
    device = resolve_device(device)
    heights = torch.as_tensor(heights, dtype=dtype, device=device)
    B = heights.shape[0]
    pos = torch.zeros((B, 3), dtype=dtype, device=device)
    pos[:, 2] = heights
    if terrain is not None:
        pos[:, 2] += terrain_mod.height_at(
            terrain, torch.zeros(2, dtype=dtype, device=device))
    foot_rel = params.default_foot_pos.to(dtype).expand(B, 4, 3).clone()
    foot_rel[..., 2] = -heights[:, None]
    q_guess = torch.tensor([0.0, 0.8, -1.6], dtype=dtype,
                           device=device).expand(B, 4, 3)
    q = kin.ik_legs(foot_rel, q_guess, params.rho_fix)
    anchor = foot_rel + pos[:, None]
    if terrain is not None:
        anchor[..., 2] = terrain_mod.height_at(terrain, anchor[..., :2])
    quat = torch.zeros((B, 4), dtype=dtype, device=device)
    quat[:, 0] = 1.0
    z3 = torch.zeros((B, 3), dtype=dtype, device=device)
    return SimState(
        pos=pos, quat=quat, vel=z3, omega=z3.clone(), q=q.reshape(B, 12),
        dq=torch.zeros((B, 12), dtype=dtype, device=device),
        contact=torch.ones((B, 4), dtype=torch.bool, device=device),
        anchor=anchor, last_acc=z3.clone())


def sim_step(s: SimState, tau, params: RobotParams, dt,
             terrain_height=0.0, terrain=None) -> SimState:
    """Advance the world by dt under joint torques tau (B,12), on a flat
    plane at z = `terrain_height` (a float) or, when `terrain` is given,
    on that height field, sampled under each foot."""
    B = s.pos.shape[0]
    R = so3.quat_to_rotmat(s.quat)
    R4 = R[:, None]
    q_legs = s.q.reshape(B, 4, 3)
    dq_legs = s.dq.reshape(B, 4, 3)
    tau_legs = tau.reshape(B, 4, 3)

    foot_rel = kin.fk_legs(q_legs, params.rho_fix)
    jac = kin.jac_legs(q_legs, params.rho_fix)
    foot_world = (R4 @ foot_rel[..., None])[..., 0] + s.pos[:, None]

    # realized ground reaction from the commanded torques, friction pyramid
    f_world = (R4 @ la3.solve3_t(jac, -tau_legs)[..., None])[..., 0]
    fz = torch.clamp(f_world[..., 2], min=0.0)
    cap = params.mu[..., None] * fz
    f_world = torch.stack([torch.maximum(torch.minimum(f_world[..., 0], cap),
                                         -cap),
                           torch.maximum(torch.minimum(f_world[..., 1], cap),
                                         -cap),
                           fz], dim=-1)

    # contact: engage only on a near-surface crossing from above (a swing
    # foot whose xy drifts under a raised cell sits below the local
    # surface: anchoring there would teleport it up the riser), release
    # when the support commanded through the leg vanishes
    if terrain is None:
        ground_h = torch.full_like(foot_world[..., 2], terrain_height)
    else:
        ground_h = terrain_mod.height_at(terrain, foot_world[..., :2])
    touching = ((foot_world[..., 2] <= ground_h)
                & (foot_world[..., 2] >= ground_h - 0.02))
    new_contact = torch.where(s.contact, fz > CONTACT_RELEASE_FZ, touching)
    fresh = (~s.contact & new_contact)[..., None]
    landed = torch.cat([foot_world[..., :2], ground_h[..., None]], dim=-1)
    anchor = torch.where(fresh, landed, s.anchor)
    grf = torch.where(new_contact[..., None], f_world,
                      torch.zeros_like(f_world))

    # trunk dynamics
    acc = (grf.sum(dim=1) / params.mass[..., None]
           + _gravity(s.pos.dtype, s.pos.device, -1.0))
    I_world = R @ params.trunk_inertia @ R.transpose(-1, -2)
    torque = torch.linalg.cross(anchor - s.pos[:, None], grf).sum(dim=1)
    Iw_om = (I_world @ s.omega[..., None])[..., 0]
    omega_dot = la3.solve3(I_world,
                           torque - torch.linalg.cross(s.omega, Iw_om))
    vel = s.vel + acc * dt
    pos = s.pos + vel * dt
    omega = s.omega + omega_dot * dt
    quat = so3.quat_integrate(s.quat, omega, dt)
    Rt_new = so3.quat_to_rotmat(quat).transpose(-1, -2)[:, None]

    # swing legs: second-order joint dynamics under the commanded torque
    ddq = (tau_legs - LEG_DAMPING * dq_legs) / LEG_INERTIA
    dq_swing = dq_legs + ddq * dt
    q_swing = q_legs + dq_swing * dt
    # stance legs: kinematic closure on the world anchor
    rel = anchor - pos[:, None]
    anchor_rel = (Rt_new @ rel[..., None])[..., 0]
    q_stance = kin.ik_legs(anchor_rel, q_legs, params.rho_fix)
    closure = (Rt_new @ (-vel[:, None] - torch.linalg.cross(
        omega[:, None].expand(B, 4, 3), rel))[..., None])[..., 0]
    dq_stance = la3.solve3(kin.jac_legs(q_stance, params.rho_fix), closure)

    on = new_contact[..., None]
    return SimState(
        pos=pos, quat=quat, vel=vel, omega=omega,
        q=torch.where(on, q_stance, q_swing).reshape(B, 12),
        dq=torch.where(on, dq_stance, dq_swing).reshape(B, 12),
        contact=new_contact, anchor=anchor, last_acc=acc)


def read_sensors(s: SimState, params: RobotParams) -> dict:
    """Raw proprioception from the sim state (the fake robot's packet),
    with the ground-truth pose for the kf_type-0 bypass."""
    Rt = so3.quat_to_rotmat(s.quat).transpose(-1, -2)
    g_up = _gravity(s.pos.dtype, s.pos.device, 1.0)
    return dict(
        quat=s.quat, pos=s.pos, vel=s.vel,
        imu_acc=(Rt @ (s.last_acc + g_up)[..., None])[..., 0],
        imu_ang_vel=(Rt @ s.omega[..., None])[..., 0],
        joint_pos=s.q, joint_vel=s.dq, contact=s.contact)
