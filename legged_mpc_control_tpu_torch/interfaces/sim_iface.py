"""On-device simulation interface — the Gazebo-equivalent backend
(`legged_mpc_control_tpu/interfaces/sim_iface.py`).

The reference's `GazeboInterface` subscribes to sim topics and publishes
per-joint torques (reference: src/legged_ctrl/src/interfaces/
GazeboInterface.cpp:9-118). Here the simulator is itself a function over
tensors (sim/srb_sim.py), so `tick()` advances controller + world one MPC
period on the state's device. `fbk_update`/`send_cmd` are provided for API
parity with the hardware backend (they pull/push through the same dict
schema, one robot without a batch axis), but the fast path is `tick`.

The port's one-robot state is a batch of one: every leaf of `loop` (and of
`lci`) carries a leading axis of 1, which `fbk_update` drops and
`send_cmd` adds.
"""

from typing import Dict, Optional

import numpy as np
import torch

from legged_mpc_control_tpu_torch import constants as C
from legged_mpc_control_tpu_torch.config import RobotParams
from legged_mpc_control_tpu_torch.control import step as step_mod
from legged_mpc_control_tpu_torch.interfaces.base import BaseInterface
from legged_mpc_control_tpu_torch.mpc import gait as gait_mod
from legged_mpc_control_tpu_torch.sim import srb_sim


class SimInterface(BaseInterface):
    """One robot on the SRB simulator, on `device` (the card unless the
    caller asks for the CPU); `params` and `pattern` live there too."""

    def __init__(self, params: RobotParams, pattern=None, *,
                 dtype=torch.float32, height=0.3, body_height=0.3,
                 horizon=10, kf_type=0, pdip_iters=15, mpc_type="convex",
                 low_level_type=0, walk_velx=0.25, device="cuda"):
        self.params = params
        self.pattern = pattern or gait_mod.trot_pattern(dtype, device)
        self.horizon = horizon
        self.kf_type = kf_type
        self.pdip_iters = pdip_iters
        self.mpc_type = mpc_type
        self.low_level_type = low_level_type
        # a Python float advanced by MPC_DT and cast at every tick, as the
        # JAX interface keeps it: a float32 clock on the device would
        # accumulate differently (ROADMAP fault 7)
        self.t = 0.0
        self.loop = step_mod.LoopState(
            controller=step_mod.controller_init(params, 1, dtype, device,
                                                body_height),
            sim=srb_sim.sim_init(params, [height], dtype, device))
        if mpc_type in ("lci", "ci"):
            # LCI backend seam (reference: main.cpp:113-121 mpc_type 0):
            # "lci" = the distilled convex walk policy; "ci" = the true
            # contact-implicit trajectory optimizer (mpc/ci_mpc.py),
            # warm-started across ticks through LciState.policy_warm
            from legged_mpc_control_tpu_torch.mpc import lci_mpc

            self._stand_policy = lci_mpc.make_stand_policy(
                params, body_height=body_height)
            if mpc_type == "ci":
                from legged_mpc_control_tpu_torch.mpc import ci_mpc

                self._walk_policy = ci_mpc.make_ci_walk_policy(
                    params, velx=walk_velx, body_height=body_height)
                self.lci = lci_mpc.lci_init(
                    dtype, self._walk_policy.warm_init(dtype, device),
                    device)
            else:
                self._walk_policy = lci_mpc.make_walk_policy(
                    params, velx=walk_velx, body_height=body_height)
                self.lci = lci_mpc.lci_init(dtype, device=device)

    def tick(self, n: int = 1):
        """Advance n MPC periods on the state's device."""
        for _ in range(n):
            if self.mpc_type in ("lci", "ci"):
                pos = self.loop.sim.pos
                self.loop, self.lci = step_mod.closed_loop_tick_lci(
                    self.loop, self.lci, self.params,
                    self._stand_policy, self._walk_policy,
                    torch.tensor(self.t, dtype=pos.dtype, device=pos.device),
                    kf_type=self.kf_type,
                    low_level_type=self.low_level_type)
            else:
                self.loop = step_mod.closed_loop_tick(
                    self.loop, self.params, self.pattern,
                    horizon=self.horizon, kf_type=self.kf_type,
                    low_level_type=self.low_level_type,
                    pdip_iters=self.pdip_iters)
            self.t += C.MPC_DT
        return self.loop

    # --- BaseInterface parity surface ---
    def fbk_update(self) -> Optional[Dict[str, np.ndarray]]:
        raw = srb_sim.read_sensors(self.loop.sim, self.params)
        return {k: v[0].detach().cpu().numpy() for k, v in raw.items()}

    def send_cmd(self, q_tgt, dq_tgt, tau_ff, kp, kd) -> bool:
        """Apply one low-level PD step to the sim world (the reference's
        Gazebo path computes tau = kp(q_d-q)+kd(dq_d-dq)+tau_ff manually,
        GazeboInterface.cpp:99-118). The commands are one robot's (12,)."""
        s = self.loop.sim

        def cmd(x):
            return torch.as_tensor(np.asarray(x), dtype=s.q.dtype,
                                   device=s.q.device)[None]
        tau = (cmd(kp) * (cmd(q_tgt) - s.q) + cmd(kd) * (cmd(dq_tgt) - s.dq)
               + cmd(tau_ff))
        self.loop = self.loop.replace(sim=srb_sim.sim_step(
            s, tau, step_mod.broadcast_params(self.params, 1),
            C.LOW_LEVEL_DT))
        return True
