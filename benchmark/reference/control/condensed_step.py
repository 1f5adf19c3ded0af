"""The batched convex tick with the upstream controller's own QP solver, in
plain PyTorch: `closed_loop_tick_batched(..., solver="admm",
fused_substeps=True, carry_feedback=True)` of the port at kf_type 0 on
flat ground, composed of the reference's MPC prepare and finish
(`mpc/convex_mpc.py`), the condensed build and ADMM solve
(`mpc/condensed.py`), and the substep chain's plain version and the
Feedback unpack (`control/step.py`).

    [feedback carried from the last chain ; MPC prepare + condensed QP +
     ADMM ; 8 substeps -> Feedback block]
"""

import torch

from benchmark.reference import constants as C
from benchmark.reference.control import step
from benchmark.reference.mpc import condensed, convex_mpc


def closed_loop_tick_admm_batched(loop, params, pattern, *, horizon=30,
                                  substeps=C.SUBSTEPS_PER_MPC_TICK, iters=30,
                                  rho=0.1, warm=None):
    """One scenario-batched convex tick solved by ADMM, the Feedback
    carried from the previous tick's chain; params batched. rho: the ADMM
    step; warm: the previous solve's (x, z, y), or None. Returns (loop',
    the solve's `condensed.AdmmResult`)."""
    dt_ll = C.MPC_DT / substeps
    cs, stage = convex_mpc.mpc_prepare(loop.controller, params, pattern,
                                       C.MPC_DT, horizon=horizon)
    qp = condensed.build_condensed_qp(
        stage.x0, stage.x_ref, stage.A_seq, stage.B, stage.contact,
        stage.q_weights, stage.r_weights, stage.mu, stage.fz_max, C.MPC_DT)
    res = condensed.solve_qp_admm_batched(qp.P, qp.q, qp.mu, qp.fz_max,
                                          qp.contact, iters=iters, rho=rho,
                                          warm=warm)
    grf = res.u[:, 0:12]
    # per-scenario NaN guard (reference: ConvexQPSolver.cpp:321-326)
    bad = torch.isnan(grf).any(dim=-1, keepdim=True)
    cs = convex_mpc.mpc_finish(cs, torch.where(bad, torch.zeros_like(grf),
                                               grf))
    out, sim = step._substep_chain(cs, loop.sim, params, substeps, dt_ll)
    cs = step.unpack_fused_feedback(cs, sim, out, params)
    return step.LoopState(controller=cs, sim=sim), res
