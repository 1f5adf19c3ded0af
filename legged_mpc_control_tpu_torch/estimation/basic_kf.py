"""18-state contact-gated linear Kalman filter
(`legged_mpc_control_tpu/estimation/basic_kf.py`, the reference's BasicKF,
src/legged_ctrl/src/estimation/BasicKF.cpp). Batch-first.

State: [root_pos(3), root_vel(3), foot_pos_world(4x3)]; 28 measurements:
4x3 body-to-foot FK residuals, 4x3 leg-odometry velocities, 4 foot heights
(reference: BasicKF.h:13-14, BasicKF.cpp:12-19). Contact gating (noise
inflation x1e3 on swing legs, reference: :94-110) is arithmetic on the
contact belief. The measurement update runs row by row (the measurement
noise is diagonal), so no 28x28 system is ever solved.
"""

import torch

from legged_mpc_control_tpu_torch.constants import GRAVITY_EST, NUM_LEG
from legged_mpc_control_tpu_torch.ops.so3 import skew
from legged_mpc_control_tpu_torch.types import KfState

STATE_SIZE = 18
MEAS_SIZE = 28

# reference: BasicKF.h:15-20
PROCESS_NOISE_PIMU = 0.01
PROCESS_NOISE_VIMU = 0.01
PROCESS_NOISE_PFOOT = 0.01
SENSOR_NOISE_PIMU_REL_FOOT = 0.001
SENSOR_NOISE_VIMU_REL_FOOT = 0.1
SENSOR_NOISE_ZFOOT = 0.001


def sequential_update(xbar, Pbar, H, err0, rdiag):
    """Kalman measurement update by sequential scalar rows.

    With diagonal measurement noise this equals the joint update: row i
    applies a rank-1 correction with innovation err0_i - H_i (x - xbar),
    all linearized at xbar.

    xbar (B, n), Pbar (B, n, n), H (m, n) shared or (B, m, n) per
    scenario (the EKF's linearization), err0 (B, m) = y - h(xbar),
    rdiag (B, m). Returns (x_new (B, n), P_new (B, n, n))."""
    dx = torch.zeros_like(xbar)
    P = Pbar
    shared = H.dim() == 2
    for i in range(H.shape[-2]):
        if shared:
            h = H[i]
            Ph = P @ h                                      # (B, n)
            s = Ph @ h + rdiag[:, i]
            dxh = dx @ h
        else:
            h = H[:, i]
            Ph = (P @ h[..., None])[..., 0]
            s = (Ph * h).sum(-1) + rdiag[:, i]
            dxh = (dx * h).sum(-1)
        K = Ph / s[:, None]
        dx = dx + K * (err0[:, i] - dxh)[:, None]
        P = P - K[:, :, None] * Ph[:, None, :]
    return xbar + dx, P


def _measurement_matrix(dtype, device):
    """Fixed C (28, 18). reference: BasicKF.cpp:12-19."""
    C = torch.zeros((MEAS_SIZE, STATE_SIZE), dtype=dtype, device=device)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    for i in range(NUM_LEG):
        C[i * 3:i * 3 + 3, 0:3] = -eye3
        C[i * 3:i * 3 + 3, 6 + i * 3:9 + i * 3] = eye3
        C[12 + i * 3:15 + i * 3, 3:6] = eye3
        C[24 + i, 8 + i * 3] = 1.0
    return C


def kf_init(root_rot_mat, foot_pos_rel) -> KfState:
    """reference: BasicKF.cpp:57-70. The body starts at (0, 0, 0.09), the
    feet from FK under the current orientation. root_rot_mat (B,3,3),
    foot_pos_rel (B,4,3); dtype and device follow them."""
    B = root_rot_mat.shape[0]
    dtype, dev = root_rot_mat.dtype, root_rot_mat.device
    x = torch.zeros((B, STATE_SIZE), dtype=dtype, device=dev)
    x[:, 2] = 0.09
    feet = (root_rot_mat[:, None] @ foot_pos_rel[..., None])[..., 0] \
        + x[:, None, 0:3]
    x[:, 6:18] = feet.reshape(B, 12)
    P = (torch.eye(STATE_SIZE, dtype=dtype, device=dev) * 3.0).expand(
        B, STATE_SIZE, STATE_SIZE).clone()
    return KfState(x=x, P=P,
                   initialized=torch.ones((B,), dtype=torch.bool, device=dev))


def kf_update(kf: KfState, dt, root_rot_mat, imu_acc, imu_ang_vel,
              foot_pos_rel, foot_vel_rel, estimated_contacts,
              assume_flat_ground=True):
    """One predict + update. reference: BasicKF.cpp:72-167.

    root_rot_mat (B,3,3); imu_acc, imu_ang_vel (B,3) body frame;
    foot_pos_rel / foot_vel_rel (B,4,3) body-frame FK; estimated_contacts
    (B,4) in [0, 1] (the sigmoid contact belief in walk mode, :81-89).
    Returns (new KfState, root_pos (B,3), root_vel (B,3))."""
    x, P = kf.x, kf.P
    B = x.shape[0]
    dtype, dev = x.dtype, x.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    A = torch.eye(STATE_SIZE, dtype=dtype, device=dev)
    A[0:3, 3:6] = dt * eye3
    # control input u = R a + g (reference: :74-78)
    u = (root_rot_mat @ imu_acc[..., None])[..., 0]
    u[:, 2] -= GRAVITY_EST

    c = estimated_contacts
    infl = 1.0 + (1.0 - c) * 1e3                                 # (B,4)

    # process noise (reference: :91-99)
    qdiag = torch.cat([
        torch.full((B, 3), PROCESS_NOISE_PIMU * dt / 20.0, dtype=dtype,
                   device=dev),
        torch.full((B, 3), PROCESS_NOISE_VIMU * dt * 9.8 / 20.0,
                   dtype=dtype, device=dev),
        torch.repeat_interleave(infl * dt * PROCESS_NOISE_PFOOT, 3, dim=-1),
    ], dim=-1)

    # measurement noise (reference: :29-34, 101-110)
    z_noise = (infl * SENSOR_NOISE_ZFOOT if assume_flat_ground
               else torch.full((B, 4), 1e5, dtype=dtype, device=dev))
    rdiag = torch.cat([
        torch.repeat_interleave(infl * SENSOR_NOISE_PIMU_REL_FOOT, 3, dim=-1),
        torch.repeat_interleave(infl * SENSOR_NOISE_VIMU_REL_FOOT, 3, dim=-1),
        z_noise], dim=-1)

    # predict (reference: :113-115)
    xbar = x @ A.T
    xbar[:, 3:6] = xbar[:, 3:6] + dt * u
    Pbar = A @ P @ A.T + torch.diag_embed(qdiag)

    # measurements (reference: :117-131)
    C = _measurement_matrix(dtype, dev)
    yhat = xbar @ C.T
    R4 = root_rot_mat[:, None]
    fk_world = (R4 @ foot_pos_rel[..., None])[..., 0]              # (B,4,3)
    leg_v = -foot_vel_rel - torch.einsum("bij,blj->bli", skew(imu_ang_vel),
                                         foot_pos_rel)
    vel_meas = ((1.0 - c)[..., None] * x[:, None, 3:6]
                + c[..., None] * (R4 @ leg_v[..., None])[..., 0])
    height_meas = (1.0 - c) * (x[:, 2:3] + foot_pos_rel[..., 2])
    y = torch.cat([fk_world.reshape(B, 12), vel_meas.reshape(B, 12),
                   height_meas], dim=-1)

    x_new, P_new = sequential_update(xbar, Pbar, C, y - yhat, rdiag)
    P_new = 0.5 * (P_new + P_new.transpose(-1, -2))

    # xy-drift suppression (reference: :146-150)
    det2 = P_new[:, 0, 0] * P_new[:, 1, 1] - P_new[:, 0, 1] * P_new[:, 1, 0]
    P_supp = P_new.clone()
    P_supp[:, 0:2, 2:] = 0.0
    P_supp[:, 2:, 0:2] = 0.0
    P_supp[:, 0:2, 0:2] = P_supp[:, 0:2, 0:2] * 0.1
    P_new = torch.where((det2 > 1e-6)[:, None, None], P_supp, P_new)

    return (kf.replace(x=x_new, P=P_new), x_new[:, 0:3], x_new[:, 3:6])
