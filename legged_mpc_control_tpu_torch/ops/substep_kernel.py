"""Kernel K2 wrapper: all substeps of one closed-loop MPC tick in one launch
(csrc/substep_chain.cu), the port of the TPU kernel
`legged_mpc_control_tpu/ops/substep_pallas.py:substep_chain_fused`
(kf_type 0).

Per substep: J^T tau + analytic IK + PD low-level control, the safety gate,
and the SRB world step (realized GRFs, contact make/break, trunk dynamics,
anchored stance closure, swing joints). The final state's Feedback products
and Raibert footholds come back as the `fb` block (FB_ROWS layout), so a
rollout can skip the per-tick feedback pass
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
N_IN = sum(n for _, n in IN_ROWS)
N_OUT = sum(n for _, n in OUT_ROWS)


def substep_chain_plain(sim_pos, sim_quat, sim_vel, sim_omega, sim_q,
                        sim_dq, sim_contact, sim_anchor, opt_state,
                        opt_input, movement_mode, mass, mu, kp_foot,
                        kd_foot, trunk_inertia, rho_fix, default_foot_pos,
                        gait_counter_speed, contact_thresh, vel_d_rel, *,
                        substeps, dt):
    """Plain version of kernel K2: the per-substep loop of the ported
    modules (low level -> sim step -> sensors -> feedback), then the `fb`
    block of the final Feedback."""
    from legged_mpc_control_tpu_torch.config import RobotParams
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.sim import srb_sim
    from legged_mpc_control_tpu_torch.types import init_ctrl, init_feedback

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
    fbk, ctrl = step._feedback(
        init_feedback(B, dtype, dev), ctrl,
        step._sim_sensors(sim, params, torch.zeros_like(sim_quat)), params)
    for _ in range(substeps):
        ctrl, tau, _safe = step._lowlevel(fbk, ctrl, params)
        sim = srb_sim.sim_step(sim, tau, params, dt)
        grf_n = step._anchored_normal_force(ctrl.joint_tau_tgt, sim,
                                            params)
        fbk, ctrl = step._feedback(fbk, ctrl,
                                   step._sim_sensors(sim, params, grf_n),
                                   params)

    fb = torch.cat([
        fbk.root_euler, fbk.root_rot_mat.reshape(B, 9),
        fbk.foot_pos_rel.reshape(B, 12), fbk.foot_pos_abs.reshape(B, 12),
        fbk.foot_vel_rel.reshape(B, 12), fbk.foot_vel_abs.reshape(B, 12),
        fbk.foot_vel_world.reshape(B, 12), fbk.jac_foot.reshape(B, 36),
        fbk.foot_force_sensor, fbk.foot_contact_flag,
        fbk.foot_contact_bool.to(dtype),
        fbk.foot_force_tau_est.reshape(B, 12),
        ctrl.foot_pos_target_abs.reshape(B, 12), fbk.imu_acc,
        fbk.imu_ang_vel], dim=-1)
    return dict(pos=sim.pos, quat=sim.quat, vel=sim.vel, omega=sim.omega,
                q=sim.q, dq=sim.dq, contact=sim.contact, anchor=sim.anchor,
                last_acc=sim.last_acc, q_tgt=ctrl.joint_ang_tgt,
                dq_tgt=ctrl.joint_vel_tgt, tau_ff=ctrl.joint_tau_tgt, fb=fb)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("substep_chain")
    lib.substep_chain_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.substep_chain_launch.restype = ctypes.c_int
    lib.substep_chain_rows.argtypes = [ctypes.c_int]
    lib.substep_chain_rows.restype = ctypes.c_int
    if (lib.substep_chain_rows(0), lib.substep_chain_rows(1)) != (N_IN, N_OUT):
        raise RuntimeError("csrc/substep_chain.cu row layout differs from "
                           "IN_ROWS/OUT_ROWS")
    return lib


def substep_chain_cuda(sim_pos, sim_quat, sim_vel, sim_omega, sim_q, sim_dq,
                       sim_contact, sim_anchor, opt_state, opt_input,
                       movement_mode, mass, mu, kp_foot, kd_foot,
                       trunk_inertia, rho_fix, default_foot_pos,
                       gait_counter_speed, contact_thresh, vel_d_rel, *,
                       substeps, dt, kf_type=0):
    """The whole substep chain of one tick for a scenario batch (kernel K2
    on CUDA, the plain version on CPU). Returns a dict of the new sim
    fields, the last joint targets (q_tgt, dq_tgt, tau_ff) and the `fb`
    block (B, 150). kf_type 1 (the in-chain KF) is not ported yet."""
    if kf_type != 0:
        raise NotImplementedError(
            "the substep chain with the in-loop KF (kf_type 1) is not "
            "ported yet")
    if sim_pos.device.type == "cpu":
        return substep_chain_plain(
            sim_pos, sim_quat, sim_vel, sim_omega, sim_q, sim_dq,
            sim_contact, sim_anchor, opt_state, opt_input, movement_mode,
            mass, mu, kp_foot, kd_foot, trunk_inertia, rho_fix,
            default_foot_pos, gait_counter_speed, contact_thresh, vel_d_rel,
            substeps=substeps, dt=dt)
    if sim_pos.dtype != torch.float32:
        raise TypeError("the CUDA substep kernel takes float32 only, got "
                        f"{sim_pos.dtype}")
    if sim_pos.device.type != "cuda":
        raise ValueError(f"tensors on {sim_pos.device}: want cuda (or cpu "
                         "for the plain version)")
    B = sim_pos.shape[0]
    dev = sim_pos.device
    args = dict(pos=sim_pos, quat=sim_quat, vel=sim_vel, omega=sim_omega,
                q=sim_q, dq=sim_dq, contact=sim_contact, anchor=sim_anchor,
                opt_state=opt_state, opt_input=opt_input, mass=mass, mu=mu,
                kp=kp_foot, kd=kd_foot, inertia=trunk_inertia, rho=rho_fix,
                dfp=default_foot_pos, gspeed=gait_counter_speed,
                thresh=contact_thresh, vel_d=vel_d_rel)
    cols = []
    for name, n in IN_ROWS:
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
    packed = torch.cat(cols, dim=1).T.contiguous()           # (N_IN, B)
    mode = movement_mode.to(torch.int32).contiguous()
    out = torch.empty((N_OUT, B), dtype=torch.float32, device=dev)

    err = _lib().substep_chain_launch(
        packed.data_ptr(), mode.data_ptr(), out.data_ptr(), B, int(substeps),
        float(dt), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "substep_chain")
    substep_chain_cuda.launches += 1

    res, off = {}, 0
    for name, n in OUT_ROWS:
        res[name] = out[off:off + n].T
        off += n
    res["anchor"] = res["anchor"].reshape(B, 4, 3)
    res["contact"] = res["contact"] > 0.5
    return res


substep_chain_cuda.launches = 0
