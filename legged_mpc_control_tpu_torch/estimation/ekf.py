"""Extended Kalman filter with leg odometry, foot and terrain states, and
mocap fusion (`legged_mpc_control_tpu/estimation/ekf.py`, the reference's
A1KFCombineLOWithFootTerrain behind BaseInterface.cpp:104-118, :424-445 and
HardwareInterface.cpp:203-228). Batch-first.

State (25): [root_pos(3), root_vel(3), root_euler(3) (roll, pitch, yaw),
foot_pos_world(4x3), terrain_height(4)]. The process and measurement
Jacobians are `torch.func.jacfwd` of the models under `torch.func.vmap`,
as the JAX package takes them with `jax.jacfwd`; the 32 measurement rows
(diagonal noise) update one by one through `basic_kf.sequential_update`.
"""

from typing import Any, NamedTuple

import torch
from torch.func import jacfwd, vmap

from legged_mpc_control_tpu_torch.constants import GRAVITY_EST, NUM_LEG
from legged_mpc_control_tpu_torch.estimation.basic_kf import (
    sequential_update,
)
from legged_mpc_control_tpu_torch.ops import so3
from legged_mpc_control_tpu_torch.types import EkfState

STATE_SIZE = 25
MEAS_SIZE = 32   # 4x3 FK residual + 4x3 leg velocity + 4 foot-vs-terrain
                 # + 4 terrain prior


class EkfNoise(NamedTuple):
    """The reference's 13 noise parameters (BaseInterface.cpp:104-118) and
    the terrain random walk of the foot + terrain states."""
    proc_pos: Any = 0.001
    proc_vel: Any = 0.01
    proc_euler: Any = 0.0005
    proc_foot_stance: Any = 0.001
    proc_foot_swing: Any = 1000.0
    meas_fk: Any = 0.005
    meas_vel: Any = 0.05
    meas_height: Any = 0.005
    meas_vel_swing_mult: Any = 1e3
    opti_pos: Any = 0.002
    opti_euler: Any = 0.002
    init_pos_unc: Any = 0.1
    init_unc: Any = 1.0
    proc_terrain_stance: Any = 1e-5
    proc_terrain_swing: Any = 0.01


def _euler_rate_matrix(eul):
    """T(rpy): body angular velocity -> ZYX euler-angle rates, with the
    pitch singularity guarded as in the JAX package."""
    r, p = eul[..., 0], eul[..., 1]
    sr, cr = torch.sin(r), torch.cos(r)
    cp, tp = torch.cos(p), torch.tan(p)
    # the guard's constant as a tensor: a Python scalar times a 0-dim
    # tensor promotes float32 to float64 under torch.func's vmap
    small = torch.full_like(cp, 1e-4)
    cp = torch.where(cp.abs() < 1e-4,
                     torch.where(cp == 0, small, torch.sign(cp) * small), cp)
    z, o = torch.zeros_like(sr), torch.ones_like(sr)
    return so3._mat([[o, sr * tp, cr * tp], [z, cr, -sr],
                     [z, sr / cp, cr / cp]])


def _rotmat(eul):
    return so3.quat_to_rotmat(so3.euler_to_quat(eul))


def _process(x, imu_acc, imu_gyro, dt):
    """IMU-driven strapdown process model (feet and terrain constant); x
    (..., 25)."""
    p, v, eul, rest = x[..., 0:3], x[..., 3:6], x[..., 6:9], x[..., 9:]
    acc_w = (_rotmat(eul) @ imu_acc[..., None])[..., 0]
    acc_w = torch.cat([acc_w[..., :2], acc_w[..., 2:] - GRAVITY_EST], -1)
    p_new = p + v * dt + 0.5 * acc_w * dt * dt
    v_new = v + acc_w * dt
    eul_new = eul + (_euler_rate_matrix(eul) @ imu_gyro[..., None])[..., 0] \
        * dt
    return torch.cat([p_new, v_new, eul_new, rest], -1)


def _measure(x, foot_pos_rel, foot_vel_rel, imu_gyro):
    """h(x): per-leg FK residual (body frame), leg-odometry velocity, foot
    height above its terrain state and the terrain prior; and the
    leg-odometry body velocities (..., 4, 3)."""
    p, v, eul = x[..., 0:3], x[..., 3:6], x[..., 6:9]
    feet = x[..., 9:21].reshape(x.shape[:-1] + (NUM_LEG, 3))
    terrain = x[..., 21:25]
    R = _rotmat(eul)
    fk_pred = torch.einsum("...ba,...lb->...la", R, feet - p[..., None, :])
    leg_v_body = -foot_vel_rel - torch.linalg.cross(
        imu_gyro[..., None, :].expand(foot_pos_rel.shape), foot_pos_rel)
    vel_pred = torch.einsum("...ba,...b->...a", R, v)
    vel_pred = vel_pred[..., None, :].expand(fk_pred.shape)
    height_pred = feet[..., 2] - terrain
    lead = x.shape[:-1]
    return torch.cat([fk_pred.reshape(lead + (12,)),
                      vel_pred.reshape(lead + (12,)), height_pred, terrain],
                     -1), leg_v_body


def ekf_init(root_quat, root_pos, foot_pos_rel,
             noise: EkfNoise = EkfNoise()) -> EkfState:
    """Initialize from the first full sensor frame (reference:
    BaseInterface.cpp:432-434): root_quat (B,4), root_pos (B,3),
    foot_pos_rel (B,4,3); dtype and device follow root_pos."""
    B = root_pos.shape[0]
    dtype, dev = root_pos.dtype, root_pos.device
    eul = so3.quat_to_euler(root_quat).to(dtype)
    R = _rotmat(eul)
    feet = (R[:, None] @ foot_pos_rel[..., None])[..., 0] + root_pos[:, None]
    x = torch.cat([root_pos, torch.zeros((B, 3), dtype=dtype, device=dev),
                   eul, feet.reshape(B, 12), feet[..., 2]], -1)

    def full(n, v):
        return torch.full((n,), v, dtype=dtype, device=dev)
    diag = torch.cat([full(3, noise.init_pos_unc), full(18, noise.init_unc),
                      full(4, noise.init_pos_unc)])
    return EkfState(x=x, P=torch.diag(diag).expand(B, STATE_SIZE,
                                                   STATE_SIZE).clone(),
                    initialized=torch.ones((B,), dtype=torch.bool,
                                           device=dev))


def ekf_update(ekf: EkfState, dt, imu_acc, imu_gyro, foot_pos_rel,
               foot_vel_rel, estimated_contacts,
               noise: EkfNoise = EkfNoise(), assume_flat_ground=True):
    """One predict + update from the IMU and leg odometry (reference:
    BaseInterface.cpp:424-437). imu_acc, imu_gyro (B,3) body frame;
    foot_pos_rel, foot_vel_rel (B,4,3); estimated_contacts (B,4) in [0, 1].
    Returns (new EkfState, pos (B,3), vel (B,3), euler (B,3))."""
    x, P = ekf.x, ekf.P
    B = x.shape[0]
    dtype, dev = x.dtype, x.device
    c = estimated_contacts.to(dtype)
    swing_infl = 1.0 + (1.0 - c) * noise.meas_vel_swing_mult

    # --- predict ---
    F = vmap(jacfwd(lambda xx, a, g: _process(xx, a, g, dt)))(
        x, imu_acc, imu_gyro)
    xbar = _process(x, imu_acc, imu_gyro, dt)
    foot_proc = c * noise.proc_foot_stance + (1.0 - c) * noise.proc_foot_swing
    terr_proc = (c * noise.proc_terrain_stance
                 + (1.0 - c) * noise.proc_terrain_swing)

    def full(n, v):
        return torch.full((B, n), v, dtype=dtype, device=dev)
    qdiag = torch.cat([full(3, noise.proc_pos * dt),
                       full(3, noise.proc_vel * dt),
                       full(3, noise.proc_euler * dt),
                       torch.repeat_interleave(foot_proc * dt, 3, dim=-1),
                       terr_proc * dt], -1)
    Pbar = F @ P @ F.transpose(-1, -2) + torch.diag_embed(qdiag)

    # --- measurement ---
    H = vmap(jacfwd(lambda xx, fp, fv, g: _measure(xx, fp, fv, g)[0]))(
        xbar, foot_pos_rel, foot_vel_rel, imu_gyro)
    yhat, leg_v_body = _measure(xbar, foot_pos_rel, foot_vel_rel, imu_gyro)
    v_body_pred = torch.einsum("bji,bj->bi", _rotmat(xbar[:, 6:9]),
                               xbar[:, 3:6])
    vel_meas = (c[..., None] * leg_v_body
                + (1.0 - c)[..., None] * v_body_pred[:, None])
    zeros4 = torch.zeros((B, NUM_LEG), dtype=dtype, device=dev)
    y = torch.cat([foot_pos_rel.reshape(B, 12), vel_meas.reshape(B, 12),
                   zeros4, zeros4], -1)   # feet ON terrain; level prior
    rdiag = torch.cat([
        torch.repeat_interleave(swing_infl * noise.meas_fk, 3, dim=-1),
        torch.repeat_interleave(swing_infl * noise.meas_vel, 3, dim=-1),
        swing_infl * noise.meas_height,
        full(4, 0.02 if assume_flat_ground else 1e6)], -1)

    x_new, P_new = sequential_update(xbar, Pbar, H, y - yhat, rdiag)
    P_new = 0.5 * (P_new + P_new.transpose(-1, -2))
    new = EkfState(x=x_new, P=P_new, initialized=ekf.initialized)
    return new, x_new[:, 0:3], x_new[:, 3:6], x_new[:, 6:9]


def ekf_update_with_opti(ekf: EkfState, opti_pos, opti_euler,
                         noise: EkfNoise = EkfNoise()) -> EkfState:
    """Fuse an external mocap pose (reference: HardwareInterface.cpp:
    203-228): a linear measurement of position and euler angles, the yaw
    innovation wrapped to (-pi, pi]. opti_pos, opti_euler (B,3)."""
    x, P = ekf.x, ekf.P
    dtype, dev = x.dtype, x.device
    H = torch.zeros((6, STATE_SIZE), dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    H[0:3, 0:3] = eye3
    H[3:6, 6:9] = eye3
    err = torch.cat([opti_pos - x[:, 0:3], opti_euler - x[:, 6:9]], -1)
    yaw = err[:, 5:6]
    err = torch.cat([err[:, :5], torch.atan2(torch.sin(yaw), torch.cos(yaw))],
                    -1)
    rdiag = torch.cat([
        torch.full((x.shape[0], 3), noise.opti_pos, dtype=dtype, device=dev),
        torch.full((x.shape[0], 3), noise.opti_euler, dtype=dtype,
                   device=dev)], -1)
    x_new, P_new = sequential_update(x, P, H, err, rdiag)
    return EkfState(x=x_new, P=0.5 * (P_new + P_new.transpose(-1, -2)),
                    initialized=ekf.initialized)


def get_state(ekf: EkfState):
    """The first 9 states are [pos, vel, euler] (reference:
    BaseInterface.cpp:439-445)."""
    return ekf.x
