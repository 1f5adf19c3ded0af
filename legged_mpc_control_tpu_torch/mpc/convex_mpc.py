"""Batched convex-MPC tick (`legged_mpc_control_tpu/mpc/convex_mpc.py`,
the reference's ConvexMpc::update, ConvexMpc.cpp:24-108).

`mpc_prepare` runs everything up to the QP (joystick filtering, gait FSM,
contact prediction, reference and linearization) for the whole batch,
`mpc_tick_batched` solves all scenarios' QPs in one solver call and
`mpc_finish` packs the GRFs and foot targets for the low-level control.
`mpc_tick` is the single-robot tick (a batch of one) with the unbatched
condensed PDIP.
Solvers: "riccati" (the stagewise IPM, kernel K1 on CUDA), "pdip" and
"admm" (the condensed dense QP of `qp_builder.py`, factored and solved by
kernels K4/K5 on CUDA).
"""

from typing import NamedTuple, Optional, Tuple

import torch

from legged_mpc_control_tpu_torch.config import RobotParams
from legged_mpc_control_tpu_torch.mpc import gait as gait_mod
from legged_mpc_control_tpu_torch.mpc import (
    admm,
    pdip,
    qp_builder,
    reference,
    riccati,
)
from legged_mpc_control_tpu_torch.ops.filters import moving_window_update
from legged_mpc_control_tpu_torch.tree import tree_map
from legged_mpc_control_tpu_torch.types import ControllerState
from legged_mpc_control_tpu_torch.utils import trace


SOLVERS = ("riccati", "pdip", "admm")


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


@trace.spanned(trace.MPC_PREPARE)
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


@trace.spanned(trace.MPC_FINISH)
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


@trace.spanned(trace.QP_CONDENSE)
def build_condensed_from_stage(stage: StageQP, dt) -> qp_builder.CondensedQP:
    """Condense a batched StageQP into the dense (P, q) form
    (`qp_builder.py`)."""
    return qp_builder.build_condensed_qp(
        stage.x0, stage.x_ref, stage.A_seq, stage.B, stage.contact,
        stage.q_weights, stage.r_weights, stage.mu, stage.fz_max, dt)


def mpc_tick(state: ControllerState, params: RobotParams,
             pattern: gait_mod.GaitPattern, dt, *, horizon: int,
             pdip_iters: int = 18) -> ControllerState:
    """One MPC update of one robot (reference: the 100 Hz thread body,
    ConvexMpc.cpp:24-62), the CLI's and the hardware loop's path: `state`
    and `params` carry a leading axis of 1 (`step.broadcast_params`); the
    QP is condensed and solved by `pdip.solve_qp_pdip` (cold, `pdip_iters`
    iterations)."""
    if state.fbk.root_pos.shape[0] != 1:
        raise ValueError("mpc_tick serves one robot (a leading axis of 1); "
                         "use mpc_tick_batched for a batch")
    state, stage = mpc_prepare(state, params, pattern, dt, horizon=horizon)
    qp = build_condensed_from_stage(stage, dt)
    res = pdip.solve_qp_pdip(qp.P[0], qp.q[0], qp.mu.reshape(-1)[0],
                             qp.fz_max.reshape(-1)[0],
                             contact=qp.contact[0], iters=pdip_iters)
    grf = res.u[None, 0:12]
    # NaN guard (reference: ConvexQPSolver.cpp:321-326)
    grf = torch.where(torch.isnan(grf).any(), torch.zeros_like(grf), grf)
    return mpc_finish(state, grf)


def mpc_tick_batched(states: ControllerState, params: RobotParams,
                     pattern: gait_mod.GaitPattern, dt, *,
                     horizon: int, iters: int = 15, solver: str = "riccati",
                     warm=None, diagnostics: bool = False,
                     admm_rho: float = 0.1
                     ) -> Tuple[ControllerState, Optional[object]]:
    """Batched MPC tick: one solver call for the whole scenario batch.

    solver: "riccati" (the stagewise IPM, kernel K1 on CUDA tensors),
    "pdip" (condensed dense IPM) or "admm" (OSQP-equivalent), the latter
    two over kernels K4/K5 on CUDA tensors.
    warm: the previous tick's warm state, mirroring the reference's
    setWarmStart(true) (ConvexQPSolver.cpp:185): for "riccati" and "pdip"
    the previous (B, 12H) solution, shifted here to this tick's schedule as
    the interior-point primal warm start; for "admm" the ADMM warm tuple.
    diagnostics (riccati): compute the dual residual after the solve.
    admm_rho (admm): the ADMM step rho, OSQP's default 0.1. On the
    Jacobi-scaled condensed QP the iteration contracts by about
    rho / (lambda + rho) along an eigenvalue lambda of the scaled Hessian,
    whose least is ~1e-4 at H=30 (~1e-3 at H=10): there rho = 0.1 leaves a
    30-iteration solve tens of N from the optimum, rho = 1e-3 within a
    fraction of a newton.
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
    elif solver == "admm":
        qp = build_condensed_from_stage(stage, dt)
        res = admm.solve_qp_admm_batched(qp.P, qp.q, qp.mu, qp.fz_max,
                                         qp.contact, iters=iters, warm=warm,
                                         rho=admm_rho)
        warm_out = res.warm
    else:
        qp = build_condensed_from_stage(stage, dt)
        wu = None if warm is None else riccati.warm_shift(warm, qp.contact)
        res = pdip.solve_qp_pdip_batched(qp.P, qp.q, qp.mu, qp.fz_max,
                                         qp.contact, iters=iters, warm_u=wu)
        warm_out = res.u
    grf = res.u[:, 0:12]
    # per-scenario NaN guard (reference: ConvexQPSolver.cpp:321-326)
    bad = torch.isnan(grf).any(dim=-1, keepdim=True)
    grf = torch.where(bad, torch.zeros_like(grf), grf)
    return mpc_finish(states, grf), warm_out
