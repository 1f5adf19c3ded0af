"""Kernels K2 and K3 wrapper: all substeps of one closed-loop MPC tick in one
launch (csrc/substep_chain.cu), the port of the TPU kernel
`legged_mpc_control_tpu/ops/substep_pallas.py:substep_chain_fused`:
kf_type 0 (K2) and kf_type 1 (K3, the 18-state KF inside every substep).

Per substep: J^T tau + analytic IK + PD low-level control, the safety gate,
and the SRB world step (realized GRFs, contact make/break, trunk dynamics,
anchored stance closure, swing joints); under kf_type 1 then the filter's
predict step and its 28 sequential measurement rows, and the low level and
the Raibert footholds read the filter's estimate of the root state. The
final state's Feedback products and Raibert footholds come back as the `fb`
block (FB_ROWS layout), so a rollout can skip the per-tick feedback pass
(`control/step.py:unpack_fused_feedback`).

`substep_chain_cuda` launches the kernel on CUDA tensors and runs the plain
version `substep_chain_plain` on CPU tensors. Both take batch-first tensors
(every parameter with its scenario axis, `step.broadcast_params`) and return
the same dict.
"""

import ctypes
import functools

import torch

from legged_mpc_control_tpu_torch.ops import cuda_build

# fb block row layout: name -> (offset, length)
FB_ROWS = {
    "euler": (0, 3), "rotmat": (3, 9), "foot_pos_rel": (12, 12),
    "foot_pos_abs": (24, 12), "foot_vel_rel": (36, 12),
    "foot_vel_abs": (48, 12), "foot_vel_world": (60, 12),
    "jac": (72, 36), "foot_force_sensor": (108, 4),
    "contact_sig": (112, 4), "contact_bool": (116, 4),
    "force_tau_est": (120, 12), "raibert_abs": (132, 12),
    "imu_acc": (144, 3), "imu_gyro": (147, 3),
}
FB_N = 150

# rows of the kernel's packed (rows, B) input and output; the same layout
# is spelled out in csrc/substep_chain.cu
IN_ROWS = (("pos", 3), ("quat", 4), ("vel", 3), ("omega", 3), ("q", 12),
           ("dq", 12), ("contact", 4), ("anchor", 12), ("opt_state", 18),
           ("opt_input", 24), ("mass", 1), ("mu", 1), ("kp", 3), ("kd", 3),
           ("inertia", 9), ("rho", 20), ("dfp", 12), ("gspeed", 1),
           ("thresh", 1), ("vel_d", 3))
OUT_ROWS = (("pos", 3), ("quat", 4), ("vel", 3), ("omega", 3), ("q", 12),
            ("dq", 12), ("contact", 4), ("anchor", 12), ("last_acc", 3),
            ("q_tgt", 12), ("dq_tgt", 12), ("tau_ff", 12), ("fb", FB_N))
# kf_type 1 appends the filter state to both
KF_ROWS = (("kf_x", 18), ("kf_P", 324))
N_IN = sum(n for _, n in IN_ROWS)
N_OUT = sum(n for _, n in OUT_ROWS)
N_KF = sum(n for _, n in KF_ROWS)


def substep_chain_plain(sim_pos, sim_quat, sim_vel, sim_omega, sim_q,
                        sim_dq, sim_contact, sim_anchor, opt_state,
                        opt_input, movement_mode, mass, mu, kp_foot,
                        kd_foot, trunk_inertia, rho_fix, default_foot_pos,
                        gait_counter_speed, contact_thresh, vel_d_rel, *,
                        substeps, dt, kf_type=0, kf_x=None, kf_P=None):
    """Plain version of kernels K2 and K3: the per-substep loop of the
    ported modules (low level -> sim step -> sensors -> feedback, with
    `feedback_update(kf_type=1)`'s filter step under kf_type 1), then the
    `fb` block of the final Feedback."""
    from legged_mpc_control_tpu_torch.config import RobotParams
    from legged_mpc_control_tpu_torch.control import sensors, step
    from legged_mpc_control_tpu_torch.sim import srb_sim
    from legged_mpc_control_tpu_torch.types import (
        KfState,
        init_ctrl,
        init_feedback,
    )

    B = sim_pos.shape[0]
    dtype, dev = sim_pos.dtype, sim_pos.device
    # the fields the chain reads; the sensor threshold enters as
    # min + 0 * (max - min), exactly `contact_thresh`
    params = RobotParams(
        mass=mass, trunk_inertia=trunk_inertia, q_weights=None,
        r_weights=None, mu=mu, fz_max=None,
        gait_counter_speed=gait_counter_speed,
        default_foot_pos=default_foot_pos, kp_foot=kp_foot, kd_foot=kd_foot,
        foot_sensor_min=contact_thresh, foot_sensor_max=contact_thresh,
        foot_sensor_ratio=torch.zeros_like(contact_thresh), rho_fix=rho_fix,
        max_body_height=None, min_body_height=None)
    sim = srb_sim.SimState(
        pos=sim_pos, quat=sim_quat, vel=sim_vel, omega=sim_omega, q=sim_q,
        dq=sim_dq, contact=sim_contact, anchor=sim_anchor,
        last_acc=torch.zeros_like(sim_pos))
    ctrl = init_ctrl(B, dtype, dev).replace(
        movement_mode=movement_mode, optimized_state=opt_state,
        optimized_input=opt_input, root_lin_vel_d_rel=vel_d_rel)
    # the opening Feedback: only its kinematic products feed the first
    # substep's low level, so the foot sensor may read zero here
    fbk, ctrl, kf = step._feedback(
        init_feedback(B, dtype, dev), ctrl, None,
        step._sim_sensors(sim, params, torch.zeros_like(sim_quat)), params,
        dt, kf_type=0)
    if kf_type == 1:
        # the first low level reads the filter's estimate of the root state
        kf = KfState(x=kf_x, P=kf_P, initialized=torch.ones(
            (B,), dtype=torch.bool, device=dev))
        fbk = fbk.replace(root_pos=kf_x[:, 0:3], root_lin_vel=kf_x[:, 3:6])
    for _ in range(substeps):
        ctrl, tau, _safe = step._lowlevel(fbk, ctrl, params)
        sim = srb_sim.sim_step(sim, tau, params, dt)
        grf_n = step._anchored_normal_force(ctrl.joint_tau_tgt, sim,
                                            params)
        fbk, ctrl, kf = step._feedback(
            fbk, ctrl, kf, step._sim_sensors(sim, params, grf_n), params, dt,
            kf_type)

    foot_vel_world = fbk.foot_vel_world
    if kf_type == 1:
        # the block's world foot velocities use the true trunk velocity,
        # as the TPU kernel's do (substep_pallas.py:634)
        foot_vel_world = sensors.sensor_update(
            fbk.replace(root_lin_vel=sim.vel), params).foot_vel_world
    fb = torch.cat([
        fbk.root_euler, fbk.root_rot_mat.reshape(B, 9),
        fbk.foot_pos_rel.reshape(B, 12), fbk.foot_pos_abs.reshape(B, 12),
        fbk.foot_vel_rel.reshape(B, 12), fbk.foot_vel_abs.reshape(B, 12),
        foot_vel_world.reshape(B, 12), fbk.jac_foot.reshape(B, 36),
        fbk.foot_force_sensor, fbk.foot_contact_flag,
        fbk.foot_contact_bool.to(dtype),
        fbk.foot_force_tau_est.reshape(B, 12),
        ctrl.foot_pos_target_abs.reshape(B, 12), fbk.imu_acc,
        fbk.imu_ang_vel], dim=-1)
    res = dict(pos=sim.pos, quat=sim.quat, vel=sim.vel, omega=sim.omega,
               q=sim.q, dq=sim.dq, contact=sim.contact, anchor=sim.anchor,
               last_acc=sim.last_acc, q_tgt=ctrl.joint_ang_tgt,
               dq_tgt=ctrl.joint_vel_tgt, tau_ff=ctrl.joint_tau_tgt, fb=fb)
    if kf_type == 1:
        res.update(kf_x=kf.x, kf_P=kf.P)
    return res


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("substep_chain")
    lib.substep_chain_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.substep_chain_launch.restype = ctypes.c_int
    lib.substep_chain_rows.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.substep_chain_rows.restype = ctypes.c_int
    rows = tuple(lib.substep_chain_rows(which, kf) for kf in (0, 1)
                 for which in (0, 1))
    if rows != (N_IN, N_OUT, N_IN + N_KF, N_OUT + N_KF):
        raise RuntimeError("csrc/substep_chain.cu row layout differs from "
                           "IN_ROWS/OUT_ROWS/KF_ROWS")
    return lib


def _check_kf(kf_type, kf_x, kf_P):
    if kf_type not in (0, 1):
        raise NotImplementedError(
            f"the substep chain takes kf_type 0 or 1, not {kf_type}")
    if kf_type == 1 and (kf_x is None or kf_P is None):
        raise ValueError("kf_type 1 needs the filter state kf_x, kf_P")


def substep_chain_cuda(sim_pos, sim_quat, sim_vel, sim_omega, sim_q, sim_dq,
                       sim_contact, sim_anchor, opt_state, opt_input,
                       movement_mode, mass, mu, kp_foot, kd_foot,
                       trunk_inertia, rho_fix, default_foot_pos,
                       gait_counter_speed, contact_thresh, vel_d_rel, *,
                       substeps, dt, kf_type=0, kf_x=None, kf_P=None):
    """The whole substep chain of one tick for a scenario batch (kernel K2,
    or K3 under kf_type 1, on CUDA; the plain version on CPU). Returns a
    dict of the new sim fields, the last joint targets (q_tgt, dq_tgt,
    tau_ff) and the `fb` block (B, 150); under kf_type 1 also the filter
    state kf_x (B, 18) and kf_P (B, 18, 18) after the last substep."""
    _check_kf(kf_type, kf_x, kf_P)
    if sim_pos.device.type == "cpu":
        return substep_chain_plain(
            sim_pos, sim_quat, sim_vel, sim_omega, sim_q, sim_dq,
            sim_contact, sim_anchor, opt_state, opt_input, movement_mode,
            mass, mu, kp_foot, kd_foot, trunk_inertia, rho_fix,
            default_foot_pos, gait_counter_speed, contact_thresh, vel_d_rel,
            substeps=substeps, dt=dt, kf_type=kf_type, kf_x=kf_x, kf_P=kf_P)
    if sim_pos.dtype != torch.float32:
        raise TypeError("the CUDA substep kernel takes float32 only, got "
                        f"{sim_pos.dtype}")
    if sim_pos.device.type != "cuda":
        raise ValueError(f"tensors on {sim_pos.device}: want cuda (or cpu "
                         "for the plain version)")
    packed, mode, out = pack(
        sim_pos, sim_quat, sim_vel, sim_omega, sim_q, sim_dq, sim_contact,
        sim_anchor, opt_state, opt_input, movement_mode, mass, mu, kp_foot,
        kd_foot, trunk_inertia, rho_fix, default_foot_pos,
        gait_counter_speed, contact_thresh, vel_d_rel, kf_type=kf_type,
        kf_x=kf_x, kf_P=kf_P)
    B, dev = sim_pos.shape[0], sim_pos.device
    err = _lib().substep_chain_launch(
        packed.data_ptr(), mode.data_ptr(), out.data_ptr(), B, int(substeps),
        float(dt), int(kf_type), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "substep_chain")
    cuda_build.LAUNCHES["substep_chain_kf1" if kf_type == 1
                        else "substep_chain"] += 1
    return unpack(out, kf_type)


def pack(sim_pos, sim_quat, sim_vel, sim_omega, sim_q, sim_dq, sim_contact,
         sim_anchor, opt_state, opt_input, movement_mode, mass, mu, kp_foot,
         kd_foot, trunk_inertia, rho_fix, default_foot_pos,
         gait_counter_speed, contact_thresh, vel_d_rel, *, kf_type=0,
         kf_x=None, kf_P=None):
    """The kernel's operands: the packed input (rows, B) float32, the
    movement mode (B,) int32 and an empty output (rows, B), on the tensors'
    device."""
    B = sim_pos.shape[0]
    dev = sim_pos.device
    args = dict(pos=sim_pos, quat=sim_quat, vel=sim_vel, omega=sim_omega,
                q=sim_q, dq=sim_dq, contact=sim_contact, anchor=sim_anchor,
                opt_state=opt_state, opt_input=opt_input, mass=mass, mu=mu,
                kp=kp_foot, kd=kd_foot, inertia=trunk_inertia, rho=rho_fix,
                dfp=default_foot_pos, gspeed=gait_counter_speed,
                thresh=contact_thresh, vel_d=vel_d_rel, kf_x=kf_x, kf_P=kf_P)
    in_rows = IN_ROWS + (KF_ROWS if kf_type == 1 else ())
    out_rows = OUT_ROWS + (KF_ROWS if kf_type == 1 else ())
    cols = []
    for name, n in in_rows:
        t = args[name]
        if t.device != dev or t.shape[0] != B or t[0].numel() != n:
            raise ValueError(f"{name}: shape {tuple(t.shape)} on {t.device},"
                             f" want ({B}, {n} values) on {dev}")
        if t.dtype == torch.bool:
            t = t.to(torch.float32)
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: want float32, got {t.dtype}")
        cols.append(t.reshape(B, n))
    if movement_mode.shape != (B,) or movement_mode.device != dev:
        raise ValueError("movement_mode: want (B,) on the same device")
    packed = torch.cat(cols, dim=1).T.contiguous()           # (rows, B)
    mode = movement_mode.to(torch.int32).contiguous()
    n_out = sum(n for _, n in out_rows)
    out = torch.empty((n_out, B), dtype=torch.float32, device=dev)
    return packed, mode, out


def unpack(out, kf_type=0):
    """The kernel's packed output (rows, B) as substep_chain_cuda's dict."""
    B = out.shape[1]
    out_rows = OUT_ROWS + (KF_ROWS if kf_type == 1 else ())
    res, off = {}, 0
    for name, n in out_rows:
        res[name] = out[off:off + n].T
        off += n
    res["anchor"] = res["anchor"].reshape(B, 4, 3)
    res["contact"] = res["contact"] > 0.5
    if kf_type == 1:
        res["kf_P"] = res["kf_P"].reshape(B, 18, 18)
    return res

