"""The contact-implicit MPC seam (`legged_mpc_control_tpu/mpc/lci_mpc.py`,
reference: src/mpc_ctrl/ci_mpc/LciMpc.cpp), batched: the pluggable-policy
MPC backend.

  * the `LeggedMPC::update` contract: consume the controller state, write
    `optimized_state` (18,) and `optimized_input` (24,) (LciMpc.cpp:131-149);
  * the policy input x in R^40 = [pos(3), rpy(3), foot_pos_abs(12) | v(3),
    omega(3), foot_vel_abs(12) | foot_force(4)] (LciMpc.cpp:62-92), with
    2-tap averaging filters on the foot positions and velocities;
  * per-mode policy selection, stand or walk (LciMpc.cpp:95-104).

A policy maps (x (B,40), t (B,)) to (B,78) = [u(12); state_des(18);
vel_des(18); state_ref(18); vel_ref(12)]. A stateful engine (`ci_stateful`,
`ci_batched`: the CI walk policy of `mpc/ci_mpc.py`) also takes and returns
its warm slot, carried in `LciState.policy_warm`. The distilled convex walk
policy (`make_walk_policy`, the `--mpc lci` choice) is not ported.
"""

import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from legged_mpc_control_tpu_torch.config import RobotParams, resolve_device
from legged_mpc_control_tpu_torch.tree import Struct


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


def lci_state_from_numpy(tree, device=None) -> LciState:
    """`LciState` from a tree of arrays keyed by field name (a JAX LciState
    through `np.asarray`; `policy_warm` None or a dict of arrays)."""
    def get(name):
        return tree[name] if isinstance(tree, dict) else getattr(tree, name)

    def t(v):
        return torch.as_tensor(np.array(v), device=device)
    warm = get("policy_warm")
    return LciState(
        prev_foot_pos=t(get("prev_foot_pos")),
        prev_foot_vel=t(get("prev_foot_vel")),
        policy_time=t(get("policy_time")), prev_mode=t(get("prev_mode")),
        policy_warm=None if warm is None else {k: t(v)
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
