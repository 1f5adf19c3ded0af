"""Batched convex-MPC tick (`legged_mpc_control_tpu/mpc/convex_mpc.py`,
the reference's ConvexMpc::update, ConvexMpc.cpp:24-108).

`mpc_prepare` runs everything up to the QP (joystick filtering, gait FSM,
contact prediction, reference and linearization) for the whole batch,
`mpc_tick_batched` solves all scenarios' QPs in one solver call and
`mpc_finish` packs the GRFs and foot targets for the low-level control.
The solver is the plain stagewise Riccati IPM (`mpc/riccati.py`).
"""

from typing import NamedTuple, Optional, Tuple

import torch

from benchmark.reference.config import RobotParams
from benchmark.reference.mpc import gait as gait_mod
from benchmark.reference.mpc import reference, riccati
from benchmark.reference.ops.filters import moving_window_update
from benchmark.reference.tree import tree_map
from benchmark.reference.types import ControllerState


SOLVERS = ("riccati",)


def check_solver(solver: str):
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; one of {SOLVERS}")


class StageQP(NamedTuple):
    """Stagewise MPC QP data, batch-first."""
    x0: torch.Tensor          # (B, 12)
    x_ref: torch.Tensor       # (B, H, 12)
    A_seq: torch.Tensor       # (B, H, 12, 12)
    B: torch.Tensor           # (B, 12, 12)
    contact: torch.Tensor     # (B, H, 4)
    q_weights: torch.Tensor   # (B, 12)
    r_weights: torch.Tensor   # (B, 12)
    mu: torch.Tensor          # (B,)
    fz_max: torch.Tensor      # (B,)


def mpc_prepare(state: ControllerState, params: RobotParams,
                pattern: gait_mod.GaitPattern, dt, *,
                horizon: int) -> Tuple[ControllerState, StageQP]:
    """Everything before the QP solve (reference: ConvexMpc.cpp:33-108 minus
    the solve). `params` carry the scenario axis (step.broadcast_params)."""
    fbk, ctrl, joy = state.fbk, state.ctrl, state.joy

    # joystick command processing (reference: ConvexMpc.cpp:33-38)
    vfx, velx_f = moving_window_update(state.vel_filter_x, joy.velx)
    vfy, vely_f = moving_window_update(state.vel_filter_y, joy.vely)
    root_pos_d = ctrl.root_pos_d.clone()
    root_pos_d[:, 2] = joy.body_height
    vel_d = ctrl.root_lin_vel_d_rel.clone()
    vel_d[:, 0] = velx_f
    vel_d[:, 1] = vely_f
    ang_d = ctrl.root_ang_vel_d_rel.clone()
    ang_d[:, 2] = joy.yaw_rate
    euler_d = ctrl.root_euler_d.clone()
    euler_d[:, 2] = euler_d[:, 2] + joy.yaw_rate * dt
    ctrl = ctrl.replace(root_pos_d=root_pos_d, root_lin_vel_d_rel=vel_d,
                        root_ang_vel_d_rel=ang_d, root_euler_d=euler_d)

    # foot update (reference: ConvexMpc.cpp:80-108)
    standing = ctrl.movement_mode == 0                            # (B,)
    gait_reset = gait_mod.gait_leg_reset(state.gait, pattern)
    gait_upd = gait_mod.gait_leg_update(
        state.gait, pattern, dt, params.gait_counter_speed,
        fbk.foot_pos_world, ctrl.foot_pos_target_world,
        fbk.foot_contact_bool)

    def pick(a, b):
        c = standing.reshape(standing.shape + (1,) * (a.dim() - 1))
        return torch.where(c, a, b)

    new_gait = tree_map(pick, gait_reset, gait_upd)
    ones = torch.ones_like(fbk.root_pos[:, :1]).expand(-1, 4)
    plan_contacts = torch.where(standing[:, None], ones,
                                gait_mod.get_contact_state(gait_upd))
    ctrl = ctrl.replace(plan_contacts=plan_contacts)

    # QP construction (reference: ConvexMpc.cpp:64-78, build half)
    cmd = reference.MpcCmd(
        root_pos_d=ctrl.root_pos_d, root_euler_d=ctrl.root_euler_d,
        root_lin_vel_d_rel=ctrl.root_lin_vel_d_rel,
        root_ang_vel_d_rel=ctrl.root_ang_vel_d_rel)
    x_ref, yaw_ref, _ = reference.build_reference(
        fbk.root_euler, fbk.root_pos, fbk.root_rot_mat, cmd, horizon, dt)
    A_seq, Bm = reference.build_linearization(
        yaw_ref, params.mass, params.trunk_inertia, fbk.root_rot_mat,
        fbk.foot_pos_abs, dt)

    # contact schedule: step 0 from the current plan, the rest predicted
    # from the FSM phase (reference: ConvexQPSolver.cpp:329-346)
    ks = torch.arange(1, horizon, dtype=x_ref.dtype,
                      device=x_ref.device) * dt
    future = gait_mod.predict_contact_state(
        new_gait, pattern, ks[:, None, None], params.gait_counter_speed)
    future = torch.where(standing[None, :, None], torch.ones_like(future),
                         future)                                  # (H-1,B,4)
    contact = torch.cat([plan_contacts[:, None], future.permute(1, 0, 2)],
                        dim=1)

    x0 = torch.cat([fbk.root_euler, fbk.root_pos, fbk.root_ang_vel,
                    fbk.root_lin_vel], dim=-1)
    stage = StageQP(x0=x0, x_ref=x_ref, A_seq=A_seq, B=Bm, contact=contact,
                    q_weights=params.q_weights, r_weights=params.r_weights,
                    mu=params.mu, fz_max=params.fz_max)
    state = state.replace(ctrl=ctrl, gait=new_gait, vel_filter_x=vfx,
                          vel_filter_y=vfy)
    return state, stage


def mpc_finish(state: ControllerState, grf) -> ControllerState:
    """Pack the GRFs (B,12) and the FSM foot targets into optimized_state /
    optimized_input (reference: ConvexMpc.cpp:49-57)."""
    ctrl = state.ctrl
    B = grf.shape[0]
    optimized_state = torch.cat(
        [ctrl.root_pos_d, ctrl.root_euler_d,
         state.gait.target_pos.reshape(B, 12)], dim=-1)
    optimized_input = torch.cat(
        [grf, state.gait.target_vel.reshape(B, 12)], dim=-1)
    ctrl = ctrl.replace(optimized_state=optimized_state,
                        optimized_input=optimized_input)
    return state.replace(ctrl=ctrl,
                         mpc_inited=torch.ones_like(state.mpc_inited))


def mpc_tick_batched(states: ControllerState, params: RobotParams,
                     pattern: gait_mod.GaitPattern, dt, *,
                     horizon: int, iters: int = 15, solver: str = "riccati",
                     warm=None, diagnostics: bool = False
                     ) -> Tuple[ControllerState, Optional[object]]:
    """Batched MPC tick: one solver call for the whole scenario batch.

    solver: "riccati" (the plain stagewise IPM).
    warm: the previous tick's warm state, mirroring the reference's
    setWarmStart(true) (ConvexQPSolver.cpp:185): the previous (B, 12H)
    solution, shifted here to this tick's schedule as the interior-point
    primal warm start.
    diagnostics (riccati): compute the dual residual after the solve.
    Returns (states', warm')."""
    check_solver(solver)
    states, stage = mpc_prepare(states, params, pattern, dt, horizon=horizon)
    if solver == "riccati":
        wu = None if warm is None else riccati.warm_shift(warm,
                                                          stage.contact)
        res = riccati.solve_qp_riccati(
            stage.x0, stage.x_ref, stage.A_seq, stage.B, stage.contact,
            stage.q_weights, stage.r_weights, stage.mu, stage.fz_max, dt,
            iters=iters, warm_u=wu, diagnostics=diagnostics)
        warm_out = res.u
    grf = res.u[:, 0:12]
    # per-scenario NaN guard (reference: ConvexQPSolver.cpp:321-326)
    bad = torch.isnan(grf).any(dim=-1, keepdim=True)
    grf = torch.where(bad, torch.zeros_like(grf), grf)
    return mpc_finish(states, grf), warm_out
