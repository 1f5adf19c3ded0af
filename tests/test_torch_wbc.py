"""The port's hierarchical QP, WBC and DLS IK against the JAX package,
float64 on the CPU:

- `hoqp.solve_ineq_qp` on the five seeded QPs of tests/test_hoqp.py and
  `hoqp.hoqp_solve` on its four two-level hierarchies and its box case, as
  batches: x within 1e-8 (only x: the null basis torch's SVD returns may
  differ from LAPACK's by a rotation within the null space, which the
  hierarchy's solution does not see).
- `wbc.wbc_update` on the standing cases of tests/test_wbc.py (all four
  feet, two swinging, an infeasible friction request, a torque-saturating
  base demand) and `wbc.wbc_from_controller` on seeded controller states:
  tau and F within 1e-6. The port takes M, nle and J from the analytic
  model, JAX from its autodiff model.
- `step.lowlevel_update(low_level_type=1)` and three ticks of one A1 robot
  on the articulated twin with the WBC (`closed_loop_tick_wb`, the recipe
  of tests/test_wb_sim.py's WBC stand) against JAX's, within 1e-6.
- `ik_dls.ik_feet` and `ik_single_leg` on tests/test_ik_dls.py's cases,
  within 1e-8.

Every JAX function is compiled once (XLA:CPU's compile count, pytest.ini)."""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu.config import a1_params as ja1
from legged_mpc_control_tpu.control import hoqp as jhoqp
from legged_mpc_control_tpu.control import step as jstep
from legged_mpc_control_tpu.control import wbc as jwbc
from legged_mpc_control_tpu.models import ik_dls as jik
from legged_mpc_control_tpu.models import whole_body as jwb
from legged_mpc_control_tpu.mpc import gait as jgait
from legged_mpc_control_tpu.sim import wb_sim as jwbs
from legged_mpc_control_tpu_torch.config import params_from_numpy
from legged_mpc_control_tpu_torch.control import hoqp as thoqp
from legged_mpc_control_tpu_torch.control import step as tstep
from legged_mpc_control_tpu_torch.control import wbc as twbc
from legged_mpc_control_tpu_torch.models import ik_dls as tik
from legged_mpc_control_tpu_torch.models import whole_body as twb
from legged_mpc_control_tpu_torch.mpc import gait as tgait
from legged_mpc_control_tpu_torch.types import wb_loop_state_from_numpy
from torch_parity import close, np_tree, params_mapping, t

F64 = jnp.float64
CPU = torch.device("cpu")
JMODEL = jwb.a1_wb_model()
TMODEL = twb.wb_model_from_numpy(JMODEL, dtype=torch.float64)
TOTAL_MASS = 6.0 + 4 * (0.595 + 0.888 + 0.151 + 0.06)


def _rand_qps(n=8, m=10, count=5):
    """tests/test_hoqp.py's random QPs (x = 0 strictly feasible)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(count):
        R = rng.standard_normal((n, n))
        out.append((R.T @ R + np.eye(n), rng.standard_normal(n),
                    rng.standard_normal((m, n)), rng.uniform(0.5, 2.0, m)))
    return [np.stack(a) for a in zip(*out)]


def _two_level(n=6, count=4):
    """tests/test_hoqp.py's two-level hierarchies."""
    rng = np.random.default_rng(1)
    out = []
    for _ in range(count):
        out.append((rng.standard_normal((2, n)), rng.standard_normal(2),
                    rng.standard_normal((3, n)), rng.uniform(0.5, 2.0, 3),
                    rng.standard_normal((3, n)), rng.standard_normal(3)))
    return [np.stack(a) for a in zip(*out)]


def _box_case(n=3):
    D0 = np.concatenate([np.eye(n), -np.eye(n)])[None]
    return (np.zeros((1, 0, n)), np.zeros((1, 0)), D0, np.ones((1, 2 * n)),
            np.eye(n)[None], np.full((1, n), 5.0))


def _tasks(xp, A0, b0, D0, f0, A1, b1, batched):
    n = A0.shape[-1]
    lead = (A0.shape[0],) if batched else ()
    T = jhoqp.HoTask if xp is jnp else thoqp.HoTask
    zD = xp.zeros(lead + (0, n), dtype=A0.dtype)
    zf = xp.zeros(lead + (0,), dtype=A0.dtype)
    return [T(A=A0, b=b0, D=D0, f=f0), T(A=A1, b=b1, D=zD, f=zf)]


@functools.lru_cache(maxsize=None)
def _jax_qps():
    H, c, D, f = _rand_qps()
    x = jax.jit(jax.vmap(lambda *a: jhoqp.solve_ineq_qp(*a, iters=25)))(
        H, c, D, f)
    two = _two_level()
    hier = jax.jit(jax.vmap(lambda *a: jhoqp.hoqp_solve(
        _tasks(jnp, *a, batched=False), 6, iters=25)))(*two)
    box = _box_case()
    boxed = jax.jit(jax.vmap(lambda *a: jhoqp.hoqp_solve(
        _tasks(jnp, *a, batched=False), 3, iters=30)))(*box)
    return np.asarray(x), np.asarray(hier), np.asarray(boxed)


def test_solve_ineq_qp_matches_jax():
    want, _, _ = _jax_qps()
    H, c, D, f = (t(a) for a in _rand_qps())
    got = thoqp.solve_ineq_qp(H, c, D, f, iters=25)
    close(got, want, 1e-8)
    # the solutions are feasible and not all interior
    slack = f - (D @ got[..., None])[..., 0]
    assert float(slack.min()) > -1e-8 and float(slack.min()) < 1e-6


# Trial 2 of the two-level hierarchies binds no inequality at its optimum,
# and A1 sees only three of null(A0)'s four directions: the fourth is
# priced by the 1e-9 damping alone, so every Newton system of its level-1
# solve has a condition number ~1e9-1e10, and the two packages' float64
# roundings (the same arithmetic in another order) land up to ~2e-6 apart
# in x, at any iteration count. Its x is held within 5e-6; the other three
# trials' within 1e-8.
FLAT_TRIAL = 2


def test_hoqp_solve_matches_jax():
    _, want, want_box = _jax_qps()
    A0, b0, D0, f0, A1, b1 = (t(a) for a in _two_level())
    got = thoqp.hoqp_solve(_tasks(torch, A0, b0, D0, f0, A1, b1, True), 6,
                           iters=25)
    sharp = [k for k in range(4) if k != FLAT_TRIAL]
    close(got[sharp], want[sharp], 1e-8)
    close(got[FLAT_TRIAL], want[FLAT_TRIAL], 5e-6)
    close((A0 @ got[..., None])[..., 0], b0, 1e-6)     # level 0 exact
    boxed = thoqp.hoqp_solve(
        _tasks(torch, *(t(a) for a in _box_case()), True), 3, iters=30)
    close(boxed, want_box, 1e-8)
    close(boxed, np.ones((1, 3)), 1e-4)               # on the box's face
    # the null basis zeroes the row space and spans the rest
    Z = thoqp.soft_nullspace(A0)
    close(A0 @ Z, np.zeros((4, 2, 6)), 1e-12)
    assert (torch.linalg.matrix_rank(Z) == 4).all()


def _standing_cases():
    """tests/test_wbc.py's standing cases as one batch: q, v, contact,
    grf, base_pos_des, base_euler_des, foot_pos_des."""
    q = np.zeros((4, 18))
    q[:, 2] = 0.35
    q[:, 6:18] = np.tile([0.0, 0.8, -1.6], 4)
    q[3, 2] = 0.2
    feet = np.asarray(jax.vmap(lambda a: jwb.foot_positions(a, JMODEL))(q))
    mg4, mg2 = TOTAL_MASS * 9.81 / 4, TOTAL_MASS * 9.81 / 2
    contact = np.ones((4, 4))
    contact[1] = [1.0, 0.0, 0.0, 1.0]
    grf = np.zeros((4, 4, 3))
    grf[0, :, 2] = mg4
    grf[1, [0, 3], 2] = mg2
    grf[2, :, 0], grf[2, :, 2] = 0.6 * mg4, mg4
    grf[3, :, 2] = 200.0
    target = feet.copy()
    target[1, [1, 2], 2] += 0.05
    base_pos = q[:, 0:3].copy()
    base_pos[3, 2] += 2.0
    return q, np.zeros((4, 18)), contact, grf, base_pos, q[:, 3:6], target


@functools.lru_cache(maxsize=None)
def _jax_wbc():
    """JAX's wbc_update on the standing cases, and its wbc_from_controller
    on the seeded controller states with, last, the state of the WBC twin
    after its first tick (what lowlevel_update(low_level_type=1) takes
    its feed-forward torques from)."""
    args = _standing_cases()
    out = jax.jit(jax.vmap(lambda q, v, c, g, bp, be, fp: jwbc.wbc_update(
        q, v, c, g, bp, be, fp, jnp.zeros((4, 3), F64), JMODEL)))(*args)
    adapter = jax.jit(jax.vmap(lambda f, c: jwbc.wbc_from_controller(
        SimpleNamespace(**f), SimpleNamespace(**c), JMODEL)))(
            *_controller_arrays())
    return [np.asarray(x) for x in out], [np.asarray(x) for x in adapter]


def test_wbc_update_matches_jax():
    (tau, q_dd, F), _ = _jax_wbc()
    args = [t(a) for a in _standing_cases()]
    got_tau, got_qdd, got_F = twbc.wbc_update(
        *args, torch.zeros((4, 4, 3), dtype=torch.float64), TMODEL)
    close(got_tau, tau, 1e-6, what="tau")
    close(got_F, F, 1e-6, what="F")
    close(got_qdd, q_dd, 1e-6, what="q_dd")
    # the tests' physics: standing forces near mg/4, the cone and the
    # torque limit hold
    close(got_F[0].reshape(4, 3)[:, 2], np.full(4, TOTAL_MASS * 9.81 / 4),
          0.1 * TOTAL_MASS * 9.81 / 4)
    Fl = got_F[2].reshape(4, 3)
    assert (Fl[:, 0].abs() <= twbc.WBC_MU * Fl[:, 2] + 1e-4).all()
    assert float(got_tau[3].abs().max()) <= twbc.TAU_LIMIT + 1e-4


def _controller_arrays(n=3):
    """The Feedback and Ctrl fields that `wbc_from_controller` reads: n
    seeded robots near the standing pose, moving, with MPC targets; then
    the WBC twin's state after its first tick."""
    rng = np.random.default_rng(9)
    rpy = rng.normal(scale=0.05, size=(n, 3))
    yaw = rpy[:, 2]
    Rz = np.zeros((n, 3, 3))
    Rz[:, 0, 0], Rz[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    Rz[:, 1, 0], Rz[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    Rz[:, 2, 2] = 1.0
    root_pos = rng.normal(scale=0.05, size=(n, 3)) + [0.0, 0.0, 0.3]
    fbk = dict(root_euler=rpy, root_pos=root_pos,
               joint_pos=np.tile([0.0, 0.8, -1.6], (n, 4))
               + rng.normal(scale=0.05, size=(n, 12)),
               root_ang_vel=rng.normal(scale=0.2, size=(n, 3)),
               root_lin_vel=rng.normal(scale=0.2, size=(n, 3)),
               joint_vel=rng.normal(scale=0.5, size=(n, 12)),
               root_rot_mat_z=Rz)
    q = np.concatenate([root_pos, rpy[:, ::-1], fbk["joint_pos"]], -1)
    feet = np.asarray(jax.vmap(lambda a: jwb.foot_positions(a, JMODEL))(q))
    opt_state = np.concatenate([
        root_pos + [0.0, 0.0, 0.01], rpy * 0.5,
        (feet + rng.normal(scale=0.01, size=feet.shape)).reshape(n, 12)],
        -1)
    grf = np.zeros((n, 4, 3))
    grf[..., 2] = TOTAL_MASS * 9.81 / 2
    grf[..., :2] = rng.normal(scale=3.0, size=(n, 4, 2))
    contact = np.array([[1.0, 0.0, 0.0, 1.0], [1.0] * 4, [0.0, 1.0, 1.0,
                                                          0.0]])[:n]
    grf *= contact[..., None]
    opt_input = np.concatenate([grf.reshape(n, 12),
                                rng.normal(scale=0.1, size=(n, 12))], -1)
    ctrl = dict(optimized_state=opt_state, optimized_input=opt_input,
                root_lin_vel_d_rel=rng.normal(scale=0.2, size=(n, 3)),
                root_ang_vel_d_rel=rng.normal(scale=0.2, size=(n, 3)),
                plan_contacts=contact)
    state1 = _jax_wbc_ticks()[2].controller
    for mine, theirs in ((fbk, state1.fbk), (ctrl, state1.ctrl)):
        for k in mine:
            mine[k] = np.concatenate([mine[k],
                                      np.asarray(getattr(theirs, k))[None]])
    return fbk, ctrl


def test_wbc_from_controller_matches_jax():
    _, (tau, F) = _jax_wbc()
    fbk, ctrl = _controller_arrays()
    got_tau, got_F = twbc.wbc_from_controller(
        SimpleNamespace(**{k: t(v) for k, v in fbk.items()}),
        SimpleNamespace(**{k: t(v) for k, v in ctrl.items()}), TMODEL)
    close(got_tau, tau, 1e-6, what="tau")
    close(got_F, F, 1e-6, what="F")
    assert got_tau.shape == (4, 12)
    # a float32 state: the hierarchy still solves in float64 (in float32
    # its 1e-8 null-space threshold lies below rounding and the standing
    # forces collapse, in the JAX package too); the inputs' float32
    # rounding is what remains
    tau32, F32_ = twbc.wbc_from_controller(
        SimpleNamespace(**{k: t(v).float() for k, v in fbk.items()}),
        SimpleNamespace(**{k: t(v).float() for k, v in ctrl.items()}),
        twb.wb_model_from_numpy(JMODEL, dtype=torch.float32))
    assert tau32.dtype == F32_.dtype == torch.float32
    close(tau32, tau, 1e-2, what="tau, float32 state")
    close(F32_, F, 1e-1, what="F, float32 state")
    # swing feet carry no force
    assert float(got_F[0].reshape(4, 3)[[1, 2]].abs().max()) < 1e-6


TICKS = 3


def _wb_params():
    return ja1(F64).replace(kp_foot=jnp.full(3, 40.0, F64),
                            kd_foot=jnp.full(3, 1.2, F64))


@functools.lru_cache(maxsize=None)
def _jax_wbc_ticks():
    """JAX's closed_loop_tick_wb with the WBC, TICKS ticks of one standing
    A1: the initial state, (q, v, tau_ff) after every tick, and the state
    after the first."""
    p = _wb_params()
    loop = jstep.LoopState(
        controller=jstep.controller_init(p, dtype=F64, body_height=0.28),
        sim=jwbs.wb_sim_init(JMODEL, p, height=0.28, dtype=F64))
    tick = jax.jit(lambda lp: jstep.closed_loop_tick_wb(
        lp, p, jgait.trot_pattern(F64), JMODEL, horizon=10,
        low_level_type=1))
    init, rec, states = np_tree(loop), [], []
    for _ in range(TICKS):
        loop = tick(loop)
        rec.append((np.asarray(loop.sim.q), np.asarray(loop.sim.v),
                    np.asarray(loop.controller.ctrl.joint_tau_tgt)))
        states.append(np_tree(loop))
    return init, rec, states[0]


def _batch1(tree):
    return jax.tree.map(lambda x: np.asarray(x)[None], tree)


def test_lowlevel_update_wbc_matches_jax():
    """lowlevel_update(low_level_type=1) = the J^T tau low level's joint
    targets and PD law with JAX's wbc_from_controller torques (on the
    twin's state after one tick) as the feed-forward."""
    _, _, state1 = _jax_wbc_ticks()
    _, (tau_ff_want, _) = _jax_wbc()
    p = tstep.broadcast_params(params_from_numpy(params_mapping(
        _wb_params())), 1)
    loop = wb_loop_state_from_numpy(_batch1(state1))
    cs, tau, safe = tstep.lowlevel_update(loop.controller, p,
                                          low_level_type=1, wb_model=TMODEL)
    close(cs.ctrl.joint_tau_tgt[0], tau_ff_want[-1], 1e-6,
          what="WBC torques")
    cs0, tau0, safe0 = tstep.lowlevel_update(loop.controller, p)
    assert torch.equal(cs.ctrl.joint_ang_tgt, cs0.ctrl.joint_ang_tgt)
    assert torch.equal(safe, safe0) and bool(safe[0])
    close(tau - tau0, (cs.ctrl.joint_tau_tgt - cs0.ctrl.joint_tau_tgt), 1e-12)
    # the WBC changed the feed-forward; the default model is A1's
    assert float((tau0 - tau).abs().max()) > 1e-3
    _, tau_default, _ = tstep.lowlevel_update(loop.controller, p,
                                              low_level_type=1)
    close(tau_default, tau, 1e-12)


def test_wbc_twin_tick_matches_jax():
    init, rec, _ = _jax_wbc_ticks()
    p = params_from_numpy(params_mapping(_wb_params()))
    loop = wb_loop_state_from_numpy(_batch1(init))
    pattern = tgait.trot_pattern(torch.float64, CPU)
    for k in range(TICKS):
        loop = tstep.closed_loop_tick_wb(loop, p, pattern, TMODEL,
                                         horizon=10, low_level_type=1)
        for got, want, name in zip((loop.sim.q, loop.sim.v,
                                    loop.controller.ctrl.joint_tau_tgt),
                                   rec[k], ("q", "v", "tau_ff")):
            close(got[0], want, 1e-6, what=f"{name} tick {k}")


Q_STAND = np.tile([0.0, 0.8, -1.6], 4)
BASE = np.array([0.0, 0.0, 0.3, 0.0, 0.0, 0.0])


def _ik_cases():
    """tests/test_ik_dls.py's round trips: five perturbed targets and warm
    starts; and a single-leg case per leg."""
    rng = np.random.default_rng(0)
    q_true = Q_STAND + rng.uniform(-0.3, 0.3, (5, 12))
    q0 = q_true + rng.uniform(-0.2, 0.2, (5, 12))
    feet = np.asarray(jax.vmap(lambda qj: jwb.foot_positions(
        jnp.concatenate([BASE, qj]), JMODEL))(q_true))
    rng = np.random.default_rng(1)
    q1 = Q_STAND + rng.uniform(-0.25, 0.25, 12)
    feet1 = np.asarray(jwb.foot_positions(jnp.concatenate([BASE, q1]),
                                          JMODEL))
    legs0 = [q1[3 * leg:3 * leg + 3] + rng.uniform(-0.15, 0.15, 3)
             for leg in range(4)]
    return q0, feet, q1, feet1, legs0


@functools.lru_cache(maxsize=None)
def _jax_ik():
    q0, feet, q1, feet1, legs0 = _ik_cases()
    full = jax.vmap(lambda a, b: jik.ik_feet(a, BASE, b, JMODEL))(q0, feet)
    legs = [jik.ik_single_leg(legs0[leg], BASE, leg, feet1[leg], JMODEL,
                              q_other=q1) for leg in range(4)]
    return jax.tree.map(np.asarray, (full, legs))


def test_ik_dls_matches_jax():
    full, legs = _jax_ik()
    q0, feet, q1, feet1, legs0 = _ik_cases()
    base = t(np.tile(BASE, (5, 1)))
    q, err, conv = tik.ik_feet(t(q0), base, t(feet), TMODEL)
    close(q, full[0], 1e-8, what="ik_feet q")
    close(err, full[1], 1e-8, what="ik_feet err")
    assert conv.all() and np.asarray(full[2]).all()
    for leg in range(4):
        ql, el, cl = tik.ik_single_leg(t(legs0[leg][None]), base[:1], leg,
                                       t(feet1[leg][None]), TMODEL,
                                       q_other=t(q1[None]))
        close(ql[0], legs[leg][0], 1e-8, what=f"leg {leg} q")
        close(el[0], legs[leg][1], 1e-8, what=f"leg {leg} err")
        assert bool(cl[0])
    # from the exact solution the iterate does not move
    q, _, conv = tik.ik_feet(t(Q_STAND[None]), base[:1], t(np.asarray(
        jwb.foot_positions(jnp.concatenate([BASE, Q_STAND]), JMODEL))[None]),
        TMODEL, iters=3)
    close(q[0], Q_STAND, 1e-12)
    assert bool(conv[0])
