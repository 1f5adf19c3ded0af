"""Batched scenario runner (`legged_mpc_control_tpu/parallel/runner.py`):
domain-randomized closed-loop rollouts of thousands of Go1/A1 scenarios on
one device (BASELINE configs 3 and 5), with any of the solvers "riccati",
"pdip" and "admm", kf_type 0, 1 or 2 and low_level_type 0 or 1; and the
same rollout against the articulated twin (`make_batched_rollout_wb`,
`init_wb_loop_batch`).

The JAX rollout was one jitted `lax.scan` over ticks; here it is a Python
loop over `closed_loop_tick_batched`, on whatever device the state lives.
"""

import torch

from legged_mpc_control_tpu_torch import constants as C
from legged_mpc_control_tpu_torch.config import RobotParams, resolve_device
from legged_mpc_control_tpu_torch.control import step as step_mod
from legged_mpc_control_tpu_torch.mpc import convex_mpc, gait as gait_mod
from legged_mpc_control_tpu_torch.sim import srb_sim, wb_sim


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
                    device="cuda") -> step_mod.LoopState:
    """Batch of standing initial states with heights drawn uniformly from
    `height_range` by `generator`. `body_height` is the commanded standing
    height (A1 0.30, Go1 0.28). The generator lives on `device`."""
    device = resolve_device(device)
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
    """Returns rollout(loop_batch, params, stand_ticks_arg=None) -> (final,
    (pos, vel)), with pos and vel the (T, B, 3) trunk trajectories.

    Every tick solves the whole batch's QPs in one solver call with the
    previous tick's warm state carried across (reference:
    ConvexQPSolver.cpp:185): the (B, 12H) solution for "riccati" and
    "pdip" (tick 0 warm-starts from zeros), the ADMM warm tuple for
    "admm". `pdip_iters` is the iteration count of either solver. With a
    nonzero `walk_velx` the batch stands `stand_ticks` ticks, then trots at
    that forward speed; a call's `stand_ticks_arg` overrides
    `stand_ticks` (None keeps it): a resumed sweep, or its second rep,
    passes the stand ticks it has left, so that it does not stand again.
    fused_substeps: the substep chain in one call
    (kernel K2, or K3 under kf_type 1, on CUDA) with the Feedback carried
    in its `fb` block; False runs the per-substep loop with a feedback pass
    every tick, as kf_type 2 and low_level_type 1 always do."""
    step_mod._check_kf_type(kf_type)
    step_mod._check_low_level_type(low_level_type)
    convex_mpc.check_solver(solver)
    fused = fused_substeps and step_mod._fused_ok(kf_type, low_level_type)

    def rollout(loop, params, stand_ticks_arg=None):
        batch = loop.sim.pos.shape[0]
        params_b = step_mod.broadcast_params(params, batch)
        if fused:
            loop = step_mod.seed_batched_feedback(
                loop, params_b, kf_type=kf_type, substeps=substeps)

        def tick(loop, warm):
            return step_mod.closed_loop_tick_batched(
                loop, params_b, pattern, horizon=horizon, substeps=substeps,
                kf_type=kf_type, iters=pdip_iters, solver=solver,
                low_level_type=low_level_type, warm=warm,
                fused_substeps=fused, carry_feedback=fused)
        loop, (pos, vel) = _roll(
            loop, loop.sim.pos, tick, horizon, solver, n_ticks, walk_velx,
            stand_ticks if stand_ticks_arg is None else stand_ticks_arg,
            lambda s: (s.pos, s.vel))
        return loop, (pos, vel)

    return rollout


def _roll(loop, like, tick, horizon, solver, n_ticks, walk_velx,
          stand_ticks, trunk):
    """The rollout loop shared by both simulators: the warm start (the
    (B, 12H) solution, or the ADMM tuple) carried across ticks, the
    stand-then-walk command, and the trunk trajectory `trunk(sim)` ->
    (pos, vel) stacked to (T, B, 3) each."""
    batch, dtype, dev = like.shape[0], like.dtype, like.device
    if solver == "admm":
        warm = step_mod.admm_warm_init(batch, horizon, dtype, dev)
    else:
        warm = torch.zeros((batch, horizon * 12), dtype=dtype, device=dev)
    pos, vel = [], []
    for k in range(n_ticks):
        walking = walk_velx != 0.0 and k >= stand_ticks
        cs = loop.controller
        cs = cs.replace(
            ctrl=cs.ctrl.replace(movement_mode=torch.full(
                (batch,), int(walking), dtype=torch.int32, device=dev)),
            joy=cs.joy.replace(velx=torch.full(
                (batch,), walk_velx, dtype=dtype, device=dev)))
        loop, warm = tick(loop.replace(controller=cs), warm)
        p, v = trunk(loop.sim)
        pos.append(p)
        vel.append(v)
    return loop, (torch.stack(pos), torch.stack(vel))


def make_batched_rollout_wb(pattern: gait_mod.GaitPattern, model, *,
                            horizon=10, n_ticks=100,
                            substeps=C.SUBSTEPS_PER_MPC_TICK, pdip_iters=12,
                            kf_type=0, walk_velx=0.0, solver="riccati",
                            low_level_type=0, n_inner=4, stand_ticks=20,
                            terrain=None):
    """`make_batched_rollout` against the articulated twin (the
    Gazebo-fidelity twin as a sweep backend): rollout(loop_batch, params,
    stand_ticks_arg=None) -> (final, (pos, vel)) with `loop.sim` a batched
    `wb_sim.WbSimState` (`init_wb_loop_batch`) and `model` its
    `models.whole_body.WbModel`.
    Every tick is `step.closed_loop_tick_wb_batched` (K1 under "riccati",
    K4 + K5 in every inner sim step, on CUDA tensors)."""
    step_mod._check_kf_type(kf_type)
    step_mod._check_low_level_type(low_level_type)
    convex_mpc.check_solver(solver)

    def rollout(loop, params, stand_ticks_arg=None):
        params_b = step_mod.broadcast_params(params, loop.sim.q.shape[0])

        def tick(loop, warm):
            return step_mod.closed_loop_tick_wb_batched(
                loop, params_b, pattern, model, horizon=horizon,
                substeps=substeps, kf_type=kf_type, iters=pdip_iters,
                solver=solver, low_level_type=low_level_type,
                n_inner=n_inner, terrain=terrain, warm=warm)
        return _roll(loop, loop.sim.q, tick, horizon, solver, n_ticks,
                     walk_velx,
                     stand_ticks if stand_ticks_arg is None
                     else stand_ticks_arg,
                     lambda s: (s.q[:, 0:3], s.v[:, 0:3]))

    return rollout


def init_wb_loop_batch(params: RobotParams, model, batch: int,
                       generator: torch.Generator,
                       height_range=(0.26, 0.30), dtype=torch.float32,
                       body_height=0.28, terrain=None,
                       device="cuda") -> step_mod.LoopState:
    """Batch of standing articulated-twin states (`wb_sim.wb_sim_init`)
    with heights drawn uniformly from `height_range` by `generator`, which
    lives on `device`; `body_height` is the commanded standing height."""
    device = resolve_device(device)
    u = torch.rand((batch,), generator=generator, dtype=dtype,
                   device=device)
    heights = height_range[0] + (height_range[1] - height_range[0]) * u
    return step_mod.LoopState(
        controller=step_mod.controller_init(params, batch, dtype, device,
                                            body_height),
        sim=wb_sim.wb_sim_init(model, params, heights, dtype, device,
                               terrain=terrain))
