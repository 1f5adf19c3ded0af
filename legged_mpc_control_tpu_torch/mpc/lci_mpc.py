"""The contact-implicit MPC seam (`legged_mpc_control_tpu/mpc/lci_mpc.py`,
reference: src/mpc_ctrl/ci_mpc/LciMpc.cpp), batch-first: the
pluggable-policy MPC backend.

  * the `LeggedMPC::update` contract: consume the controller state, write
    `optimized_state` (18,) and `optimized_input` (24,) (LciMpc.cpp:131-149);
  * the policy input x in R^40 = [pos(3), rpy(3), foot_pos_abs(12) | v(3),
    omega(3), foot_vel_abs(12) | foot_force(4)] (LciMpc.cpp:62-92), with
    2-tap averaging filters on the foot positions and velocities;
  * per-mode policy selection, stand or walk (LciMpc.cpp:95-104).

A policy maps (x (B,40), t (B,)) to (B,78) = [u(12); state_des(18);
vel_des(18); state_ref(18); vel_ref(12)]: the built-in stand policy
(`make_stand_policy`) and the distilled convex trot (`make_walk_policy`,
the `--mpc lci` choice). A stateful engine (`ci_stateful`) also takes and
returns its warm slot, carried in `LciState.policy_warm`: batch-native
(`ci_batched`: `ci_mpc.make_ci_walk_policy_batched`) in the batched seam
`lci_mpc_tick_batched`, or single-robot (`(x (40,), t, warm)`:
`ci_mpc.make_ci_walk_policy`, `ci_mpc.make_ci_lean_policy`) in the
single-robot seam `lci_mpc_tick`, a B=1 view of the batched one.
"""

import functools
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from legged_mpc_control_tpu_torch.config import RobotParams, resolve_device
from legged_mpc_control_tpu_torch.tree import Struct
from legged_mpc_control_tpu_torch.utils import trace

# a stateless policy: (x (B, X_DIM), t (B,)) -> (B, OUT_DIM)
PolicyFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
X_DIM = 40
OUT_DIM = 78


@dataclass
class LciState(Struct):
    """Filter and clock state (LciMpc.cpp:37-59) of every scenario, plus an
    opaque warm-start slot for a stateful engine."""
    prev_foot_pos: torch.Tensor   # (B,4,3) previous tick's foot pos
    prev_foot_vel: torch.Tensor   # (B,4,3)
    policy_time: torch.Tensor     # (B,) time since the mode switch
    prev_mode: torch.Tensor       # (B,) int32
    policy_warm: Any = None       # engine-defined dict of tensors, or None


def lci_init_batched(batch: int, dtype=torch.float32, policy_warm=None,
                     device="cuda") -> LciState:
    """policy_warm: the batched warm slot of a stateful engine
    (`make_ci_walk_policy_batched(...).warm_init(batch, dtype, device)`)."""
    device = resolve_device(device)

    def z(*shape, dt=dtype):
        return torch.zeros((batch,) + shape, dtype=dt, device=device)
    return LciState(prev_foot_pos=z(4, 3), prev_foot_vel=z(4, 3),
                    policy_time=z(), prev_mode=z(dt=torch.int32),
                    policy_warm=policy_warm)


def lci_init(dtype=torch.float32, policy_warm=None,
             device="cuda") -> LciState:
    """The single-robot seam's state: a batch of one, with `policy_warm`
    the single-robot policy's own warm slot (`policy.warm_init(dtype,
    device)`, e.g. `ci_mpc.make_ci_lean_policy`'s {"u": (H,NU), "valid":
    ()}), carried as the policy takes it."""
    return lci_init_batched(1, dtype, policy_warm, device)


def lci_state_from_numpy(tree, device=None) -> LciState:
    """`LciState` from a tree of arrays keyed by field name (a JAX LciState
    through `np.asarray`; `policy_warm` None or a dict of arrays). An
    unbatched JAX state (prev_foot_pos (4,3), from `lci_init`) gets the
    single-robot seam's leading axis of 1 on its filter and clock leaves;
    its warm slot is carried as it is."""
    def get(name):
        return tree[name] if isinstance(tree, dict) else getattr(tree, name)

    lead = np.ndim(get("prev_foot_pos")) == 2

    def t(v, add=lead):
        v = torch.as_tensor(np.array(v), device=device)
        return v[None] if add else v
    warm = get("policy_warm")
    return LciState(
        prev_foot_pos=t(get("prev_foot_pos")),
        prev_foot_vel=t(get("prev_foot_vel")),
        policy_time=t(get("policy_time")), prev_mode=t(get("prev_mode")),
        policy_warm=None if warm is None else {k: t(v, False)
                                               for k, v in warm.items()})


def lci_state_to_numpy(s: LciState) -> dict:
    def n(v):
        return v.detach().cpu().numpy()
    return {"prev_foot_pos": n(s.prev_foot_pos),
            "prev_foot_vel": n(s.prev_foot_vel),
            "policy_time": n(s.policy_time), "prev_mode": n(s.prev_mode),
            "policy_warm": None if s.policy_warm is None else {
                k: n(v) for k, v in s.policy_warm.items()}}


def pack_policy_state(fbk, lci: LciState):
    """x (B,40) with the 2-tap foot filters (LciMpc.cpp:62-92). Returns
    (x, filtered foot positions, filtered foot velocities)."""
    B = fbk.root_pos.shape[0]
    foot_pos_f = 0.5 * (fbk.foot_pos_abs + lci.prev_foot_pos)
    foot_vel_f = 0.5 * (fbk.foot_vel_abs + lci.prev_foot_vel)
    x = torch.cat([fbk.root_pos, fbk.root_euler, foot_pos_f.reshape(B, 12),
                   fbk.root_lin_vel, fbk.root_ang_vel,
                   foot_vel_f.reshape(B, 12), fbk.foot_force_sensor], -1)
    return x, foot_pos_f, foot_vel_f


@trace.spanned(trace.LCI_SEAM)
def lci_mpc_tick_batched(state, lci: LciState, stand_policy, walk_policy, t,
                         dt):
    """One LCI-MPC update of every scenario (LciMpc.cpp:45-153). A walk
    policy with `ci_batched` takes and returns the warm slot; otherwise it
    is a stateless batched `(x, t) -> out`. `t` is unused (each scenario's
    policy clock restarts at a mode switch), as in the JAX seam. Returns
    (ControllerState', LciState')."""
    if getattr(walk_policy, "ci_stateful", False) and not getattr(
            walk_policy, "ci_batched", False):
        raise TypeError("a single-robot stateful walk policy cannot serve a "
                        "batch: use ci_mpc.make_ci_walk_policy_batched")
    fbk, ctrl = state.fbk, state.ctrl
    mode = ctrl.movement_mode
    # a mode change resets the policy clock (LciMpc.cpp:46-59)
    changed = mode != lci.prev_mode
    policy_time = torch.where(changed, torch.zeros_like(lci.policy_time),
                              lci.policy_time + dt)
    x, _, _ = pack_policy_state(fbk, lci)
    out_stand = stand_policy(x, policy_time)
    if getattr(walk_policy, "ci_batched", False):
        out_walk, warm2 = walk_policy(x, policy_time, lci.policy_warm)
    else:
        out_walk, warm2 = walk_policy(x, policy_time), lci.policy_warm
    out = torch.where((mode == 0)[:, None], out_stand, out_walk)
    u, state_des, vel_des = out[:, 0:12], out[:, 12:30], out[:, 30:48]
    new_ctrl = ctrl.replace(
        optimized_state=state_des[:, 0:18],
        optimized_input=torch.cat([u, vel_des[:, 6:18]], -1),
        plan_contacts=fbk.foot_contact_flag.to(ctrl.plan_contacts.dtype))
    new_lci = LciState(prev_foot_pos=fbk.foot_pos_abs,
                       prev_foot_vel=fbk.foot_vel_abs,
                       policy_time=policy_time, prev_mode=mode,
                       policy_warm=warm2)
    return state.replace(ctrl=new_ctrl,
                         mpc_inited=torch.ones_like(state.mpc_inited)), \
        new_lci


def lci_mpc_tick(state, lci: LciState, stand_policy, walk_policy, t, dt):
    """One LCI-MPC update of one robot (LciMpc.cpp:45-153), the B=1 view
    of `lci_mpc_tick_batched`: `state` and `lci` carry a leading axis of 1
    (`lci_init`), as `step.closed_loop_tick`'s state does. A single-robot
    stateful walk policy (`ci_stateful` without `ci_batched`: `(x (40,), t,
    warm) -> ((78,), warm')`) takes and returns its own warm slot, which
    the batched seam refuses; a batched one and the stateless policies
    serve the batch of one. Returns (ControllerState', LciState')."""
    if state.fbk.root_pos.shape[0] != 1:
        raise ValueError("lci_mpc_tick serves one robot (a leading axis of "
                         "1); use lci_mpc_tick_batched for a batch")
    walk = walk_policy
    if getattr(walk_policy, "ci_stateful", False) and not getattr(
            walk_policy, "ci_batched", False):
        def walk(x, tb, warm):
            out, warm2 = walk_policy(x[0], tb[0], warm)
            return out[None], warm2
        walk.ci_stateful = walk.ci_batched = True
    return lci_mpc_tick_batched(state, lci, stand_policy, walk, t, dt)


def make_walk_policy(params: RobotParams, velx=0.25, body_height=0.3,
                     gait_freq=None, swing_clearance=0.08, horizon=8,
                     dt_plan=0.02, qp_iters=12, fz_min=5.0):
    """Built-in trot walk policy for the LCI slot (reference: p_walk,
    LciMpc.cpp:95-104), the `--mpc lci` choice, batch-first: `(x (B,40),
    t (B,)) -> (B,78)`. A distilled convex MPC: the policy's own trot
    clock (the policy time alone, as the reference's Julia policies)
    gives a predicted contact schedule, and the GRFs come from a
    short-horizon condensed SRB QP over it (`horizon` x 12 variables),
    solved by the unbatched PDIP's rule per scenario (`pdip.solve_qp_pdip`,
    `qp_iters` iterations: kernels K4 and K5 at n = 12 horizon on the
    card); horizon prediction holds the two-feet tipping mode that a
    quasi-static wrench split cannot. Swing feet track a Bezier arc to a
    Raibert foothold with zero velocity targets (the reference's Bezier
    outputs zero velocity, Utils.cpp:179-192). gait_freq None: the
    robot's gait_counter_speed, read once here."""
    from legged_mpc_control_tpu_torch.control import raibert
    from legged_mpc_control_tpu_torch.mpc import pdip, qp_builder, reference
    from legged_mpc_control_tpu_torch.ops import bezier, so3

    if gait_freq is None:
        gait_freq = float(params.gait_counter_speed)

    @functools.lru_cache(maxsize=None)
    def consts(dtype, device):
        def c(v):
            return torch.tensor(v, dtype=dtype, device=device)
        return (c([0.0, 0.5, 0.5, 0.0]), c([velx, 0.0, 0.0]),
                c([0.0, 0.0, body_height]), c([0.0, 0.0, 2.0 * fz_min]),
                torch.arange(horizon, dtype=dtype, device=device) * dt_plan)

    def policy(x, t):
        dtype, dev = x.dtype, x.device
        B = x.shape[0]
        offs, vcmd, pos_d, boot_f, ks = consts(dtype, dev)
        t = torch.as_tensor(t, dtype=dtype, device=dev).expand(B)
        pos, euler = x[:, 0:3], x[:, 3:6]
        foot_abs = x[:, 6:18].reshape(B, 4, 3)   # CoM-origin world axes
        v, omega = x[:, 18:21], x[:, 21:24]
        foot_force = x[:, 36:40]                 # measured normal forces

        # the policy's trot clock (legs FL, RR vs FR, RL)
        phase = torch.remainder(t * gait_freq, 1.0)
        leg_phase = torch.remainder(phase[:, None] + offs, 1.0)
        contact = (leg_phase < 0.5).to(dtype)
        # a clock-stance foot is support only once it carries force (the
        # convex path's FSM: early contact, LeggedContactFSM.cpp:61-66)
        grounded = (foot_force > 2.0).to(dtype)
        support = contact * grounded
        # the arc completes at 75 % of swing: margin to touch down before
        # the clock flips the leg to stance
        swing_s = torch.clamp((leg_phase - 0.5) * 2.0 / 0.75, 0.0, 1.0)

        # GRFs: a short-horizon SRB QP over the clock's future schedule
        yaw = euler[:, 2]
        Rz = so3.rot_z(yaw)
        R = so3.quat_to_rotmat(so3.euler_to_quat(euler))
        vcmd_b = vcmd.expand(B, 3)
        v_d = (Rz @ vcmd[:, None])[..., 0]
        zeros2 = torch.zeros((B, 2), dtype=dtype, device=dev)
        eul_des = torch.cat([zeros2, yaw[:, None]], -1)
        cmd = reference.MpcCmd(
            root_pos_d=pos_d.expand(B, 3), root_euler_d=eul_des,
            root_lin_vel_d_rel=vcmd_b,
            root_ang_vel_d_rel=torch.zeros_like(vcmd_b))
        x_ref, yaw_ref, _ = reference.build_reference(euler, pos, R, cmd,
                                                      horizon, dt_plan)
        A_seq, Bm = reference.build_linearization(
            yaw_ref, params.mass.to(dtype), params.trunk_inertia.to(dtype),
            R, foot_abs, dt_plan)
        phase_k = torch.remainder((t[:, None] + ks)[..., None] * gait_freq
                                  + offs, 1.0)
        sched = (phase_k < 0.5).to(dtype)                       # (B,H,4)
        sched[:, 0] = support        # now: the actually loaded feet only
        x0 = torch.cat([euler, pos, omega, v], -1)
        qp = qp_builder.build_condensed_qp(
            x0, x_ref, A_seq, Bm, sched, params.q_weights, params.r_weights,
            params.mu, params.fz_max, dt_plan)
        # the unbatched solve's freeze rule (`solve_qp_pdip`, which is this
        # call at B=1) for every scenario
        res = pdip._solve(qp.P, qp.q, qp.mu, qp.fz_max, sched,
                          iters=qp_iters, tol=None, warm_u=None,
                          dual_freeze=False)
        grf = res.u[:, 0:12]
        grf = torch.where(torch.isnan(grf).any(-1, keepdim=True),
                          torch.zeros_like(grf), grf)
        # bootstrap load on clock-stance feet not yet registering force:
        # the force estimate comes from the commanded feed-forward, so an
        # unloaded foot must be commanded into the ground before the
        # support detector can see it
        u = (grf.reshape(B, 4, 3) * support[..., None]
             + (contact * (1.0 - grounded))[..., None] * boot_f)

        # swing: a Bezier arc from the current foot to the foothold, aimed
        # marginally below the ground so the PD loads the foot
        target_abs, _ = raibert.raibert_footholds(pos, v, Rz, vcmd_b, params)
        foot_world = foot_abs + pos[:, None]
        below = torch.full_like(foot_world[..., 2:], -0.01)
        target_world = torch.cat([(target_abs + pos[:, None])[..., 0:2],
                                  below], -1)
        arc = bezier.swing_foot_pos(swing_s, foot_world, target_world)
        arc = torch.cat([arc[..., 0:2], arc[..., 2:] + swing_clearance
                         * torch.sin(torch.pi * swing_s)[..., None]], -1)
        # clock-stance feet hold once grounded and push straight down while
        # airborne (a hold in the air would never load the foot)
        push_down = torch.cat([foot_world[..., 0:2], below], -1)
        stance_tgt = torch.where(grounded[..., None] > 0.5, foot_world,
                                 push_down)
        foot_tgt = torch.where(contact[..., None] > 0.5, stance_tgt, arc)

        state_des = torch.cat([pos[:, 0:2], pos_d[2:].expand(B, 1), eul_des,
                               foot_tgt.reshape(B, 12)], -1)
        vel_des = torch.cat([v_d, torch.zeros((B, 15), dtype=dtype,
                                              device=dev)], -1)
        return torch.cat([u.reshape(B, 12), state_des, vel_des, state_des,
                          torch.zeros((B, 12), dtype=dtype, device=dev)], -1)

    return policy


def make_stand_policy(params: RobotParams, body_height=0.3,
                      kp=(120.0, 120.0, 200.0), kd=(20.0, 20.0, 30.0)):
    """Built-in hover policy for the stand slot, batched: world-frame PD on
    the body mapped to equal per-foot forces, holding the current
    stance."""
    @functools.lru_cache(maxsize=None)
    def consts(dtype, device):
        def c(v):
            return torch.tensor(v, dtype=dtype, device=device)
        return c(kp), c(kd), c([0.0, 0.0, 9.8])

    def policy(x, t):
        dtype, dev = x.dtype, x.device
        B = x.shape[0]
        kp_t, kd_t, up = consts(dtype, dev)
        pos = x[:, 0:3]
        foot_pos = x[:, 6:18].reshape(B, 4, 3)
        v = x[:, 18:21]
        pos_des = torch.cat([pos[:, 0:2],
                             torch.full((B, 1), body_height, dtype=dtype,
                                        device=dev)], -1)
        f_body = kp_t * (pos_des - pos) - kd_t * v + up * params.mass
        u = (f_body / 4.0).repeat(1, 4)
        state_des = torch.cat([pos_des,
                               torch.zeros((B, 3), dtype=dtype, device=dev),
                               (foot_pos + pos[:, None]).reshape(B, 12)], -1)
        return torch.cat([u, state_des,
                          torch.zeros((B, 18), dtype=dtype, device=dev),
                          state_des,
                          torch.zeros((B, 12), dtype=dtype, device=dev)], -1)

    return policy
