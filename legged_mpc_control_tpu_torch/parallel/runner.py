"""Batched scenario runner (`legged_mpc_control_tpu/parallel/runner.py`):
domain-randomized closed-loop rollouts of thousands of Go1/A1 scenarios on
one device (BASELINE configs 3 and 5).

The JAX rollout was one jitted `lax.scan` over ticks; here it is a Python
loop over `closed_loop_tick_batched`, on whatever device the state lives.
"""

import torch

from legged_mpc_control_tpu_torch import constants as C
from legged_mpc_control_tpu_torch.config import RobotParams
from legged_mpc_control_tpu_torch.control import step as step_mod
from legged_mpc_control_tpu_torch.mpc import gait as gait_mod
from legged_mpc_control_tpu_torch.sim import srb_sim


def randomize_params(params: RobotParams, generator: torch.Generator,
                     batch: int, mass_range=(0.8, 1.2), mu_range=(0.5, 1.2),
                     speed_range=(0.9, 1.1)) -> RobotParams:
    """Per-scenario mass / friction / gait-speed scales: those leaves get a
    leading batch axis, the rest stay shared."""
    def scale(x, lo, hi):
        u = torch.rand((batch,), generator=generator, dtype=x.dtype,
                       device=generator.device)
        return x.to(generator.device) * (lo + (hi - lo) * u)
    return params.replace(
        mass=scale(params.mass, *mass_range), mu=scale(params.mu, *mu_range),
        gait_counter_speed=scale(params.gait_counter_speed, *speed_range))


def init_loop_batch(params: RobotParams, batch: int,
                    generator: torch.Generator, height_range=(0.27, 0.32),
                    dtype=torch.float32, body_height=0.3,
                    device=None) -> step_mod.LoopState:
    """Batch of standing initial states with heights drawn uniformly from
    `height_range` by `generator`. `body_height` is the commanded standing
    height (A1 0.30, Go1 0.28). The generator lives on `device`."""
    u = torch.rand((batch,), generator=generator, dtype=dtype,
                   device=device)
    heights = height_range[0] + (height_range[1] - height_range[0]) * u
    return step_mod.LoopState(
        controller=step_mod.controller_init(params, batch, dtype, device,
                                            body_height),
        sim=srb_sim.sim_init(params, heights, dtype, device))


def make_batched_rollout(pattern: gait_mod.GaitPattern, *, horizon=10,
                         n_ticks=100, substeps=C.SUBSTEPS_PER_MPC_TICK,
                         pdip_iters=12, kf_type=0, walk_velx=0.0,
                         solver="riccati", low_level_type=0, stand_ticks=0,
                         fused_substeps=True):
    """Returns rollout(loop_batch, params) -> (final, (pos, vel)), with pos
    and vel the (T, B, 3) trunk trajectories.

    Every tick solves the whole batch's QPs in one Riccati IPM call with
    the previous tick's solution as warm start (reference:
    ConvexQPSolver.cpp:185; tick 0 warm-starts from zeros). With a nonzero
    `walk_velx` the batch stands `stand_ticks` ticks, then trots at that
    forward speed. fused_substeps: the substep chain in one call (kernel K2
    on CUDA) with the Feedback carried in its `fb` block; False runs the
    per-substep loop with a feedback pass every tick."""
    step_mod._check_kf_type(kf_type)
    if solver != "riccati":
        raise NotImplementedError(
            f"solver {solver!r} is not ported yet; use 'riccati'")

    def rollout(loop, params):
        batch = loop.sim.pos.shape[0]
        dtype, dev = loop.sim.pos.dtype, loop.sim.pos.device
        params_b = step_mod.broadcast_params(params, batch)
        warm = torch.zeros((batch, horizon * 12), dtype=dtype, device=dev)
        if fused_substeps:
            loop = step_mod.seed_batched_feedback(loop, params_b,
                                                  substeps=substeps)
        pos, vel = [], []
        for k in range(n_ticks):
            walking = walk_velx != 0.0 and k >= stand_ticks
            cs = loop.controller
            cs = cs.replace(
                ctrl=cs.ctrl.replace(movement_mode=torch.full(
                    (batch,), int(walking), dtype=torch.int32, device=dev)),
                joy=cs.joy.replace(velx=torch.full(
                    (batch,), walk_velx, dtype=dtype, device=dev)))
            loop, warm = step_mod.closed_loop_tick_batched(
                loop.replace(controller=cs), params_b, pattern,
                horizon=horizon, substeps=substeps, kf_type=kf_type,
                iters=pdip_iters, solver=solver,
                low_level_type=low_level_type, warm=warm,
                fused_substeps=fused_substeps,
                carry_feedback=fused_substeps)
            pos.append(loop.sim.pos)
            vel.append(loop.sim.vel)
        return loop, (torch.stack(pos), torch.stack(vel))

    return rollout
