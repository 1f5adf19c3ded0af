"""Whole-body controller (`legged_mpc_control_tpu/control/wbc.py`): the
hierarchical task-priority QP of the reference's `Wbc` + `HoQp`
(wbc.cpp:93-259, HoQp.cpp:147-174). Batch-first. Decision vector
x = [q_dd (18), F (12), tau (12)] (wbc.h:18) over the hierarchy

  priority 0: floating-base dynamics M q_dd - J^T F - S^T tau = -nle
      (full J, wbc.cpp:106-120); no contact motion J_c q_dd = -Jdot_c v
      (:137-152); swing-foot forces = 0 (:156-166); |tau| <= 33.5 Nm
      (:122-135); the friction pyramid on contact feet, mu = 0.3, fz >= 0
      (:168-176)
  priority 1: base linear and angular acceleration by a PD law on the
      base pose (:181-208); swing-foot Cartesian PD, kp 350, kd 37
      (:210-246)
  priority 2: the MPC's ground reaction forces (:248-259)

resolved by `control/hoqp.py`. M, nle and J come from the analytic batched
model (`models/whole_body_b.py`), Jdot v from `torch.func.jvp` of its foot
Jacobians; the JAX package takes them from its autodiff model, which the
analytic one matches to rounding.
"""

from types import SimpleNamespace

import torch
from torch.func import jvp

from legged_mpc_control_tpu_torch.control import hoqp
from legged_mpc_control_tpu_torch.models import whole_body_b as wbb
from legged_mpc_control_tpu_torch.ops import so3

N_X = 18 + 12 + 12      # [q_dd, F, tau]
TAU_LIMIT = 33.5        # reference: task.info:225-230
WBC_MU = 0.3            # reference: task.info frictionConeTask
SWING_KP = 350.0        # reference: task.info:237-240
SWING_KD = 37.0
BASE_KP_POS = 100.0     # per axis, base position and euler angles
BASE_KD_POS = 10.0
BASE_KP_ANG = 100.0
BASE_KD_ANG = 10.0

# the Feedback and Ctrl fields `wbc_from_controller` reads
_FBK_READ = ("root_euler", "root_pos", "joint_pos", "root_ang_vel",
             "root_lin_vel", "joint_vel", "root_rot_mat_z")
_CTRL_READ = ("optimized_state", "optimized_input", "root_lin_vel_d_rel",
              "root_ang_vel_d_rel", "plan_contacts")

# 5-row friction pyramid per foot (reference: wbc.cpp:168-171):
# fz >= 0, |fx| <= mu fz, |fy| <= mu fz
_PYR = ((0.0, 0.0, -1.0),
        (1.0, 0.0, -WBC_MU),
        (-1.0, 0.0, -WBC_MU),
        (0.0, 1.0, -WBC_MU),
        (0.0, -1.0, -WBC_MU))


def _foot_jdot_v(q, v, model):
    """Jdot(q, v) v (B,4,3): the derivative of J(q) v along v."""
    def jv(qq):
        return (wbb.foot_jacobians_b(qq, model) @ v[:, None, :, None])[..., 0]
    return jvp(jv, (q,), (v,))[1]


def build_tasks(q, v, contact, grf_mpc, base_pos_des, base_euler_des,
                foot_pos_des, foot_vel_des, model, base_lin_vel_des=None,
                base_eul_rate_des=None):
    """The three priority levels as HoTasks, contact-dependent rows zeroed
    so the shapes stay fixed. q, v (B,18); contact (B,4) in {0, 1};
    grf_mpc, foot_pos_des, foot_vel_des (B,4,3); base_pos_des,
    base_euler_des (ZYX), base_lin_vel_des (world), base_eul_rate_des
    (B,3), the last two zero when None."""
    B, dtype, dev = q.shape[0], q.dtype, q.device
    M, nle, J, feet = wbb.dyn_terms_b(q, v, model)
    jdv = _foot_jdot_v(q, v, model)
    foot_vel = (J @ v[:, None, :, None])[..., 0]
    Jflat = J.reshape(B, 12, 18)
    cm = torch.repeat_interleave(contact, 3, dim=-1)         # (B,12)
    sm = torch.repeat_interleave(1.0 - contact, 3, dim=-1)

    def zeros(*shape):
        return torch.zeros((B,) + shape, dtype=dtype, device=dev)

    def eye(k):
        return torch.eye(k, dtype=dtype, device=dev).expand(B, k, k)

    # --- priority 0 ---
    S_t = torch.cat([zeros(6, 12), eye(12)], -2)              # (B,18,12)
    A_dyn = torch.cat([M, -Jflat.transpose(-1, -2), -S_t], -1)
    A_cm = torch.cat([Jflat, zeros(12, 24)], -1) * cm[..., None]
    b_cm = -jdv.reshape(B, 12) * cm
    A_sf = torch.cat([zeros(12, 18), eye(12), zeros(12, 12)], -1) \
        * sm[..., None]
    A0 = torch.cat([A_dyn, A_cm, A_sf], -2)
    b0 = torch.cat([-nle, b_cm, zeros(12)], -1)
    sel_tau = torch.cat([zeros(12, 30), eye(12)], -1)
    pyr = torch.tensor(_PYR, dtype=dtype, device=dev)          # (5,3)
    D_pyr = zeros(20, N_X)
    for leg in range(4):
        D_pyr[:, 5 * leg:5 * leg + 5, 18 + 3 * leg:21 + 3 * leg] = \
            pyr * contact[:, leg, None, None]
    D0 = torch.cat([sel_tau, -sel_tau, D_pyr], -2)
    f0 = torch.cat([torch.full((B, 24), TAU_LIMIT, dtype=dtype, device=dev),
                    zeros(20)], -1)
    task0 = hoqp.HoTask(A=A0, b=b0, D=D0, f=f0)

    # --- priority 1: base and swing tracking ---
    if base_lin_vel_des is None:
        base_lin_vel_des = zeros(3)
    if base_eul_rate_des is None:
        base_eul_rate_des = zeros(3)
    base_acc_des = (BASE_KP_POS * (base_pos_des - q[:, 0:3])
                    + BASE_KD_POS * (base_lin_vel_des - v[:, 0:3]))
    base_ang_des = (BASE_KP_ANG * (base_euler_des - q[:, 3:6])
                    + BASE_KD_ANG * (base_eul_rate_des - v[:, 3:6]))
    A_base = torch.cat([eye(6), zeros(6, N_X - 6)], -1)
    acc_sw = (SWING_KP * (foot_pos_des - feet)
              + SWING_KD * (foot_vel_des - foot_vel) - jdv)
    A_sw = torch.cat([Jflat, zeros(12, 24)], -1) * sm[..., None]
    A1 = torch.cat([A_base, A_sw], -2)
    b1 = torch.cat([base_acc_des, base_ang_des, acc_sw.reshape(B, 12) * sm],
                   -1)
    task1 = hoqp.HoTask(A=A1, b=b1, D=zeros(0, N_X), f=zeros(0))

    # --- priority 2: follow the MPC's forces ---
    A2 = torch.cat([zeros(12, 18), eye(12), zeros(12, 12)], -1)
    task2 = hoqp.HoTask(A=A2, b=grf_mpc.reshape(B, 12), D=zeros(0, N_X),
                        f=zeros(0))
    return task0, task1, task2


def wbc_update(q, v, contact, grf_mpc, base_pos_des, base_euler_des,
               foot_pos_des, foot_vel_des, model, *, base_lin_vel_des=None,
               base_eul_rate_des=None, ip_iters: int = 18):
    """One WBC solve through the hierarchy (shapes as `build_tasks`).
    Returns (tau (B,12), q_dd (B,18), F (B,12))."""
    tasks = build_tasks(q, v, contact, grf_mpc, base_pos_des,
                        base_euler_des, foot_pos_des, foot_vel_des, model,
                        base_lin_vel_des=base_lin_vel_des,
                        base_eul_rate_des=base_eul_rate_des)
    x = hoqp.hoqp_solve(tasks, N_X, iters=ip_iters)
    return x[:, 30:42], x[:, 0:18], x[:, 18:30]


def wbc_from_controller(fbk, ctrl, model, *, ip_iters: int = 14):
    """The controller's Feedback and targets -> WBC feed-forward torques,
    packed as the reference's `Wbc::update` takes them
    (BaseInterface.cpp:502-557, wbc.cpp:49-57): q = [base pos, ZYX euler,
    joints], euler-rate base velocity; the desired base pose, swing targets
    and GRFs from the MPC's optimized_state / optimized_input. The MPC
    commands only the height (ConvexMpc.cpp:33-38): xy is held by the
    commanded velocity.

    The hierarchy is solved in float64 whatever the state's dtype (the
    outputs come back in it): its constants, the 1e-8 null-space threshold
    relative to the largest singular value, the 1e-9 damping and the IPM's
    1e-11 gap, are float64 settings (the reference solves with qpOASES in
    double). In float32 the null space's singular values, ~1e-7 of the
    largest, pass the threshold: the lower levels lose their freedom and a
    standing robot gets 0.3-7.6 N of its ~30 N per foot (the JAX package's
    float32 wbc_update as well). Returns (tau (B,12), F (B,12))."""
    dtype = fbk.root_pos.dtype
    fbk, ctrl = (SimpleNamespace(**{k: getattr(o, k).double() for k in keys})
                 for o, keys in ((fbk, _FBK_READ), (ctrl, _CTRL_READ)))
    rpy = fbk.root_euler
    q = torch.cat([fbk.root_pos, rpy.flip(-1), fbk.joint_pos], -1)
    eul_rates = so3.euler_zyx_rates_from_omega_world(
        rpy[:, 2], rpy[:, 1], fbk.root_ang_vel)
    v = torch.cat([fbk.root_lin_vel, eul_rates, fbk.joint_vel], -1)
    B = q.shape[0]
    opt_s, opt_u = ctrl.optimized_state, ctrl.optimized_input
    base_pos_des = torch.cat([fbk.root_pos[:, 0:2], opt_s[:, 2:3]], -1)
    base_euler_des = opt_s[:, 3:6].flip(-1)                  # rpy -> zyx
    base_lin_vel_des = (fbk.root_rot_mat_z
                        @ ctrl.root_lin_vel_d_rel[..., None])[..., 0]
    yaw_rate = ctrl.root_ang_vel_d_rel[:, 2:3]
    base_eul_rate_des = torch.cat(
        [yaw_rate, torch.zeros_like(yaw_rate), torch.zeros_like(yaw_rate)],
        -1)
    tau, _q_dd, F = wbc_update(
        q, v, ctrl.plan_contacts, opt_u[:, 0:12].reshape(B, 4, 3),
        base_pos_des, base_euler_des, opt_s[:, 6:18].reshape(B, 4, 3),
        opt_u[:, 12:24].reshape(B, 4, 3), model,
        base_lin_vel_des=base_lin_vel_des,
        base_eul_rate_des=base_eul_rate_des, ip_iters=ip_iters)
    return tau.to(dtype), F.to(dtype)
