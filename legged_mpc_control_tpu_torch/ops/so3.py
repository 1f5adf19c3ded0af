"""SO(3) utilities (`legged_mpc_control_tpu/ops/so3.py`).

Quaternions are [w, x, y, z]; Euler angles are roll-pitch-yaw as in the
reference's Utils.cpp:7-106; rotation matrices are world-from-body. Every
function broadcasts over leading axes.
"""

import torch


def quat_to_euler(q):
    """Quaternion -> roll-pitch-yaw. reference: Utils.cpp:7-33."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    y_sqr = y * y
    t0 = 2.0 * (w * x + y * z)
    t1 = 1.0 - 2.0 * (x * x + y_sqr)
    roll = torch.atan2(t0, t1)
    t2 = torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.asin(t2)
    t3 = 2.0 * (w * z + x * y)
    t4 = 1.0 - 2.0 * (y_sqr + z * z)
    yaw = torch.atan2(t3, t4)
    return torch.stack([roll, pitch, yaw], dim=-1)


def euler_to_quat(euler):
    """Roll-pitch-yaw -> quaternion. reference: Utils.cpp:64-87."""
    hr, hp, hy = euler[..., 0] / 2, euler[..., 1] / 2, euler[..., 2] / 2
    cy, sy = torch.cos(hy), torch.sin(hy)
    cp, sp = torch.cos(hp), torch.sin(hp)
    cr, sr = torch.cos(hr), torch.sin(hr)
    w = cy * cp * cr + sy * sp * sr
    x = cy * cp * sr - sy * sp * cr
    y = cy * sp * cr + sy * cp * sr
    z = sy * cp * cr - cy * sp * sr
    return torch.stack([w, x, y, z], dim=-1)


def _mat(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_to_rotmat(q):
    """Quaternion -> rotation matrix (world-from-body)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return _mat([[1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
                 [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
                 [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)]])


def skew(v):
    """3-vector -> skew-symmetric matrix. reference: Utils.cpp:89-95."""
    zero = torch.zeros_like(v[..., 0])
    return _mat([[zero, -v[..., 2], v[..., 1]],
                 [v[..., 2], zero, -v[..., 0]],
                 [-v[..., 1], v[..., 0], zero]])


def rot_z(yaw):
    """Rotation about +z (reference: BaseInterface.cpp:219)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return _mat([[c, -s, zero], [s, c, zero], [zero, zero, one]])


def angvel_to_rpy_rate(yaw):
    """Yaw-only map from world angular velocity to rpy rates
    (reference: ConvexQPSolver.cpp:214-228)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return _mat([[c, s, zero], [-s, c, zero], [zero, zero, one]])


def euler_zyx_rates_from_omega_world(yaw, pitch, omega_world):
    """Exact ZYX euler-angle rates [dyaw, dpitch, droll] from the world
    angular velocity (reference: wbc.cpp:53-55): solves
    omega_world = T(yaw, pitch) rates with
        T = [[0, -sin(yaw), cos(yaw) cos(pitch)],
             [0,  cos(yaw), sin(yaw) cos(pitch)],
             [1,  0,        -sin(pitch)        ]].
    Singular at pitch = +-pi/2, like the reference's own mapping."""
    from legged_mpc_control_tpu_torch.ops import la3

    sy, cy = torch.sin(yaw), torch.cos(yaw)
    sp, cp = torch.sin(pitch), torch.cos(pitch)
    z, o = torch.zeros_like(sy), torch.ones_like(sy)
    T = _mat([[z, -sy, cy * cp], [z, cy, sy * cp], [o, z, -sp]])
    return la3.solve3(T, omega_world)


def quat_mul(q1, q2):
    """Hamilton product of quaternions [w,x,y,z]."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_integrate(q, omega_world, dt):
    """Exponential-map integration of a unit quaternion under a world-frame
    angular velocity held over dt."""
    angle = torch.linalg.vector_norm(omega_world, dim=-1, keepdim=True)
    half = 0.5 * angle * dt
    small = angle < 1e-8
    scale = torch.where(small, torch.full_like(angle, 0.5 * dt),
                        torch.sin(half) / torch.where(
                            small, torch.ones_like(angle), angle))
    dq = torch.cat([torch.cos(half), omega_world * scale], dim=-1)
    out = quat_mul(dq, q)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)
