"""PyTorch port vs the JAX package: the gait FSM, the MPC reference and
linearization, `mpc_prepare`, and the Riccati IPM's plain version (the
reference of kernel K1) against both the JAX XLA solver (f64) and the JAX
Pallas kernel in interpret mode (f32)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from legged_mpc_control_tpu.config import go1_params as jgo1
from legged_mpc_control_tpu.control import step as jstep
from legged_mpc_control_tpu.mpc import convex_mpc as jmpc
from legged_mpc_control_tpu.mpc import gait as jgait
from legged_mpc_control_tpu.mpc import reference as jref
from legged_mpc_control_tpu.mpc import riccati as jric
from legged_mpc_control_tpu.ops import riccati_pallas as rp
from legged_mpc_control_tpu.ops import so3 as jso3
from legged_mpc_control_tpu.parallel import runner as jrunner
from legged_mpc_control_tpu_torch.config import params_from_numpy
from legged_mpc_control_tpu_torch.mpc import convex_mpc as tmpc
from legged_mpc_control_tpu_torch.mpc import gait as tgait
from legged_mpc_control_tpu_torch.mpc import reference as tref
from legged_mpc_control_tpu_torch.mpc import riccati as tric
from legged_mpc_control_tpu_torch.types import loop_state_from_numpy
from torch_parity import close, close_tree, np_tree, params_mapping, t

ATOL = 1e-10
DT = 0.01
B = 6
H = 10
_rng = np.random.default_rng(1)


# --- gait FSM --------------------------------------------------------------

K_GAIT = 40
FOOT_CUR = _rng.normal(scale=0.2, size=(K_GAIT, B, 4, 3))
FOOT_TGT = _rng.normal(scale=0.2, size=(K_GAIT, B, 4, 3))
FORCE_FLAG = _rng.uniform(size=(K_GAIT, B, 4)) < 0.3
SPEED = _rng.uniform(3.5, 4.5, size=(B,))


@pytest.fixture(scope="module")
def jax_gait():
    pattern = jgait.trot_pattern(jnp.float64)
    legs = jnp.arange(4, dtype=jnp.int32)

    def run(cur, tgt, flag, speed):
        s0 = jax.vmap(lambda _: jax.vmap(
            jgait.gait_leg_init, in_axes=(None, 0, None))(
            pattern, legs, jnp.float64))(jnp.arange(B))

        def upd(s, inp):
            c, g, f = inp
            s = jax.vmap(lambda sb, cb, gb, fb, sp: jax.vmap(
                jgait.gait_leg_update,
                in_axes=(0, None, 0, None, None, 0, 0, 0))(
                sb, pattern, legs, DT, sp, cb, gb, fb))(s, c, g, f, speed)
            contact = jax.vmap(jax.vmap(jgait.get_contact_state))(s)
            pred = jax.vmap(lambda sb, sp: jax.vmap(
                jgait.predict_contact_state,
                in_axes=(0, None, 0, None, None))(
                sb, pattern, legs, 0.07, sp))(s, speed)
            return s, (s, contact, pred)

        s, trace = jax.lax.scan(upd, s0, (cur, tgt, flag))
        reset = jax.vmap(lambda sb: jax.vmap(
            jgait.gait_leg_reset, in_axes=(0, None, 0))(
            sb, pattern, legs))(s)
        return trace, reset

    return np_tree(jax.jit(run)(FOOT_CUR, FOOT_TGT, FORCE_FLAG, SPEED))


def test_gait_fsm_matches_jax(jax_gait):
    (states, contacts, preds), reset = jax_gait
    pattern = tgait.trot_pattern(torch.float64, "cpu")
    s = tgait.gait_leg_init(pattern, B, torch.float64)
    for k in range(K_GAIT):
        s = tgait.gait_leg_update(s, pattern, DT, t(SPEED), t(FOOT_CUR[k]),
                                  t(FOOT_TGT[k]), t(FORCE_FLAG[k]))
        want = jax.tree.map(lambda x: x[k], states)
        close_tree(s, want, ATOL, what=f"tick {k}")
        close(tgait.get_contact_state(s), contacts[k], 0.0)
        close(tgait.predict_contact_state(s, pattern, 0.07, t(SPEED)),
              preds[k], 0.0)
    close_tree(tgait.gait_leg_reset(s, pattern), reset, ATOL, what="reset")


# --- reference and linearization -------------------------------------------

def test_reference_and_linearization_match_jax():
    p = jgo1(jnp.float64)
    euler = _rng.uniform(-0.2, 0.2, size=(B, 3))
    pos = _rng.normal(size=(B, 3))
    R = np.asarray(jso3.quat_to_rotmat(jso3.euler_to_quat(euler)))
    cmd = [_rng.normal(size=(B, 3)) for _ in range(4)]
    feet = _rng.normal(scale=0.2, size=(B, 4, 3))
    mass = _rng.uniform(10, 15, size=(B,))

    def ref(euler, pos, R, c0, c1, c2, c3, feet, mass):
        cmd = jref.MpcCmd(c0, c1, c2, c3)
        x_ref, yaw_ref, lv = jref.build_reference(euler, pos, R, cmd, H, DT)
        A, Bm = jref.build_linearization(yaw_ref, mass, p.trunk_inertia, R,
                                         feet, DT)
        return x_ref, yaw_ref, lv, A, Bm

    want = jax.jit(jax.vmap(ref))(euler, pos, R, *cmd, feet, mass)
    got_ref = tref.build_reference(t(euler), t(pos), t(R),
                                   tref.MpcCmd(*[t(c) for c in cmd]), H, DT)
    inertia = t(np.broadcast_to(np.asarray(p.trunk_inertia), (B, 3, 3)))
    got_lin = tref.build_linearization(got_ref[1], t(mass), inertia, t(R),
                                       t(feet), DT)
    for g, w, name in zip(got_ref + got_lin, want,
                          ("x_ref", "yaw_ref", "lin_vel_d_world", "A_seq",
                           "B")):
        close(g, w, ATOL, what=name)


# --- mpc_prepare -----------------------------------------------------------

K_PREP = 12


@pytest.fixture(scope="module")
def prepare_case():
    """A Go1 batch with its feedback seeded, then randomized contact bools
    and foot positions; half the batch walks for the first 8 ticks."""
    p = jgo1(jnp.float64)
    loop = jrunner.init_loop_batch(p, B, jax.random.PRNGKey(5),
                                   dtype=jnp.float64, body_height=0.28)
    pb = jax.jit(jstep.broadcast_params, static_argnums=1)(p, B)
    loop = jax.jit(jstep.seed_batched_feedback)(loop, pb)
    cs = loop.controller
    cs = cs.replace(
        fbk=cs.fbk.replace(
            foot_contact_bool=jnp.asarray(_rng.uniform(size=(B, 4)) < 0.5),
            foot_pos_world=cs.fbk.foot_pos_world
            + _rng.normal(scale=0.01, size=(B, 4, 3))),
        joy=cs.joy.replace(velx=jnp.full((B,), 0.25),
                           yaw_rate=jnp.full((B,), 0.1)))
    loop = loop.replace(controller=cs)
    modes = np.zeros((K_PREP, B), np.int32)
    modes[:8, : B // 2] = 1
    pattern = jgait.trot_pattern(jnp.float64)

    @jax.jit
    def prep(cs, mode):
        cs = cs.replace(ctrl=cs.ctrl.replace(movement_mode=mode))
        return jax.vmap(lambda s, q: jmpc.mpc_prepare(
            s, q, pattern, DT, horizon=H))(cs, pb)

    trace = []
    for k in range(K_PREP):
        cs, stage = prep(cs, modes[k])
        trace.append(np_tree((cs, stage)))
    return np_tree(loop), modes, params_mapping(pb), trace


def test_mpc_prepare_matches_jax(prepare_case):
    loop_np, modes, pmap, trace = prepare_case
    cs = loop_state_from_numpy(loop_np).controller
    params = params_from_numpy(pmap)
    pattern = tgait.trot_pattern(torch.float64, "cpu")
    for k in range(K_PREP):
        cs = cs.replace(ctrl=cs.ctrl.replace(movement_mode=t(modes[k])))
        cs, stage = tmpc.mpc_prepare(cs, params, pattern, DT, horizon=H)
        want_cs, want_stage = trace[k]
        close_tree(cs, want_cs, ATOL, what=f"state {k}")
        for name in ("x0", "x_ref", "A_seq", "B", "contact", "q_weights",
                     "r_weights", "mu", "fz_max"):
            close(getattr(stage, name), getattr(want_stage, name), ATOL,
                  what=f"{name} {k}")


# --- Riccati IPM -----------------------------------------------------------

def _problem(batch, dtype):
    params, x0, contact = ge._make_problem_batch(batch, H, dtype)
    x_ref, A_seq, Bm = jax.jit(ge._lin_batch_fn(params, H))(x0)
    return (x0, x_ref, A_seq, Bm, contact,
            jnp.asarray(params.q_weights, dtype),
            jnp.asarray(params.r_weights, dtype),
            jnp.asarray(params.mu, dtype), jnp.asarray(params.fz_max, dtype))


def _torch_args(args):
    return tuple(t(a) for a in args)


@pytest.fixture(scope="module")
def f64_solves():
    args = _problem(6, jnp.float64)
    solve = jax.jit(functools.partial(jric.solve_qp_riccati_batched,
                                      dt=DT, iters=15))
    cold = solve(*args)
    warm_u = jric.warm_shift(cold.u, args[4])
    warm = solve(*args, warm_u=warm_u)
    return [np.asarray(a) for a in args], np_tree(cold), np_tree(warm)


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_riccati_plain_matches_jax_xla_f64(f64_solves, start):
    args, cold, warm = f64_solves
    targs = _torch_args(args)
    warm_u = None
    want = cold
    if start == "warm":
        warm_u = tric.warm_shift(t(cold.u), targs[4])
        close(warm_u, jric.warm_shift(cold.u, args[4]), 0.0, what="shift")
        want = warm
    u, gap, lam = tric.solve_qp_riccati_batched(*targs, DT, iters=15,
                                                warm_u=warm_u)
    # the same algorithm in float64: only the order of operations differs
    close(u, want.u, 1e-6, what="u [N]")
    close(gap, want.gap, 1e-9, what="gap")
    r_dual = tric.dual_residual_batched(u, lam, *targs[:8], DT)
    close(r_dual, want.r_dual, 1e-6, what="r_dual")


@pytest.mark.parametrize("batch", [6, 5])
def test_riccati_plain_f32_matches_pallas_interpret(batch):
    args = _problem(batch, jnp.float32)
    want_u, want_gap, _ = rp.solve_qp_riccati_fused(*args, DT, iters=15,
                                                    interpret=True)
    u, gap, lam = tric.solve_qp_riccati_batched(*_torch_args(args), DT,
                                                iters=15)
    assert u.dtype == torch.float32 and u.shape == (batch, 12 * H)
    assert lam.shape == (batch, H, 4, 6)
    # two f32 orderings of the same algorithm: ~1e-4 relative on ~100 N
    # (the bracket of tests/test_riccati_fused.py)
    close(u, want_u, 2e-2, what="u [N]")
    assert bool((gap < 1e-4).all()) and bool(np.all(np.asarray(want_gap)
                                                    < 1e-4))
    fz = u.reshape(batch, H, 4, 3)[..., 2]
    assert bool((fz > -1e-4).all())


def test_dispatcher_reports_dual_residual_only_on_request(f64_solves):
    args, cold, _ = f64_solves
    targs = _torch_args(args)
    res = tric.solve_qp_riccati(*targs, DT, iters=15, diagnostics=False)
    assert bool((res.r_dual == -1.0).all())
    res = tric.solve_qp_riccati(*targs, DT, iters=15, diagnostics=True)
    close(res.r_dual, cold.r_dual, 1e-6)
    close(res.u, cold.u, 1e-6)
