"""The port's EKF (`estimation/ekf.py`) and kf_type 2 in its ticks against
the JAX package, float64 on the CPU.

- The process and measurement Jacobians (`torch.func.jacfwd` under `vmap`
  against `jax.jacfwd`), `ekf_init`, four `ekf_update` steps with stance,
  swing and in-between contact beliefs, and `ekf_update_with_opti` with a
  yaw innovation across the +-pi seam: within 1e-10 (the same float64
  arithmetic in another order).
- `step.feedback_update(kf_type=2)`: the first call initializes each
  filter and keeps the root state, later calls step it, and the mocap keys
  are fused (within 1e-10).
- `make_batched_rollout(kf_type=2)`: Go1, B=4, 3 standing + 3 trotting
  ticks (within 1e-6 at every tick), against the JAX rollout (XLA backend).
- `closed_loop_tick(kf_type=2)` on one A1 robot with simulated mocap fused
  every tick (the recipe of tests/test_ekf.py's closed-loop walk, cut to
  2 standing + 2 walking ticks), within 1e-6.

Inputs are drawn with numpy from a seed; every JAX function is compiled
once (XLA:CPU's compile count, pytest.ini)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from legged_mpc_control_tpu.config import a1_params as ja1
from legged_mpc_control_tpu.config import go1_params as jgo1
from legged_mpc_control_tpu.control import step as jstep
from legged_mpc_control_tpu.estimation import ekf as jekf
from legged_mpc_control_tpu.mpc import gait as jgait
from legged_mpc_control_tpu.ops import so3 as jso3
from legged_mpc_control_tpu.parallel import runner as jrunner
from legged_mpc_control_tpu.sim import srb_sim as jsim
from legged_mpc_control_tpu_torch.config import params_from_numpy
from legged_mpc_control_tpu_torch.control import step as tstep
from legged_mpc_control_tpu_torch.estimation import ekf as tekf
from legged_mpc_control_tpu_torch.mpc import gait as tgait
from legged_mpc_control_tpu_torch.ops import so3 as tso3
from legged_mpc_control_tpu_torch.parallel import runner as trunner
from legged_mpc_control_tpu_torch.sim import srb_sim as tsim
from legged_mpc_control_tpu_torch.types import EkfState, loop_state_from_numpy
from torch_parity import close, close_tree, np_tree, params_mapping, t

F64 = jnp.float64
CPU = torch.device("cpu")
B = 5
DT = 0.00125
STEPS = 4
ATOL = 1e-10
_rng = np.random.default_rng(21)


def _contacts(n):
    c = _rng.choice([0.0, 1.0, 0.5], size=(n, 4))
    return np.where(c == 0.5, _rng.uniform(size=(n, 4)), c)


QUAT = _rng.normal(size=(B, 4)) * [1.0, 0.1, 0.1, 0.3] + [3.0, 0, 0, 0]
QUAT /= np.linalg.norm(QUAT, axis=1, keepdims=True)
POS = _rng.normal(scale=0.1, size=(B, 3)) + [0.0, 0.0, 0.3]
FPR = _rng.normal(scale=0.05, size=(B, 4, 3)) + [0.0, 0.0, -0.3]
MEAS = [dict(acc=_rng.normal(size=(B, 3)) + [0.0, 0.0, 9.81],
             gyro=_rng.normal(scale=0.3, size=(B, 3)),
             fpr=_rng.normal(scale=0.05, size=(B, 4, 3)) + [0.0, 0.0, -0.3],
             fvr=_rng.normal(scale=0.3, size=(B, 4, 3)),
             c=_contacts(B)) for _ in range(STEPS)]
OPTI_POS = POS + _rng.normal(scale=0.01, size=(B, 3))
OPTI_EUL = _rng.normal(scale=0.05, size=(B, 3))


@functools.lru_cache(maxsize=None)
def _jax_filter():
    """ekf_init, STEPS ekf_update calls, then the mocap update, on the JAX
    side; and the Jacobians at the first step."""
    init = jax.jit(jax.vmap(lambda q, p, f: jekf.ekf_init(q, p, f,
                                                          dtype=F64)))
    update = jax.jit(jax.vmap(
        lambda s, a, g, fp, fv, c: jekf.ekf_update(s, DT, a, g, fp, fv, c)))
    opti = jax.jit(jax.vmap(jekf.ekf_update_with_opti))
    st = init(QUAT, POS, FPR)
    trace = [np_tree(st)]
    for m in MEAS:
        st, pos, vel, eul = update(st, m["acc"], m["gyro"], m["fpr"],
                                   m["fvr"], m["c"])
        trace.append((np_tree(st), np.asarray(pos), np.asarray(vel),
                      np.asarray(eul)))
    # the yaw of scenario 0 across the seam: 3.1 against mocap's -3.1
    x = st.x.at[0, 8].set(3.1)
    eul = OPTI_EUL.copy()
    eul[0, 2] = -3.1
    fused = opti(st.replace(x=x), OPTI_POS, eul)
    m0 = MEAS[0]
    x0 = trace[0].x
    F = jax.jit(jax.vmap(jax.jacfwd(lambda x, a, g: jekf._process(
        x, a, g, DT))))(x0, m0["acc"], m0["gyro"])
    H = jax.jit(jax.vmap(jax.jacfwd(lambda x, fp, fv, g: jekf._measure(
        x, fp, fv, g)[0])))(x0, m0["fpr"], m0["fvr"], m0["gyro"])
    return trace, (np.asarray(x), eul, np_tree(fused)), (np.asarray(F),
                                                         np.asarray(H))


def test_ekf_jacobians_match_jax():
    trace, _, (F, H) = _jax_filter()
    m0 = MEAS[0]
    x0 = t(trace[0].x)
    got_F = vmap(jacfwd(lambda x, a, g: tekf._process(x, a, g, DT)))(
        x0, t(m0["acc"]), t(m0["gyro"]))
    got_H = vmap(jacfwd(lambda x, fp, fv, g: tekf._measure(
        x, fp, fv, g)[0]))(x0, t(m0["fpr"]), t(m0["fvr"]), t(m0["gyro"]))
    close(got_F, F, ATOL, what="F")
    close(got_H, H, ATOL, what="H")
    assert got_H.shape == (B, tekf.MEAS_SIZE, tekf.STATE_SIZE)


def test_ekf_init_and_updates_match_jax():
    trace, (x_seam, eul_seam, fused), _ = _jax_filter()
    st = tekf.ekf_init(t(QUAT), t(POS), t(FPR))
    close_tree(st, trace[0], ATOL, "init")
    for k, m in enumerate(MEAS):
        st, pos, vel, eul = tekf.ekf_update(
            st, DT, t(m["acc"]), t(m["gyro"]), t(m["fpr"]), t(m["fvr"]),
            t(m["c"]))
        want, wpos, wvel, weul = trace[k + 1]
        close_tree(st, want, ATOL, f"step {k}")
        for g, w in ((pos, wpos), (vel, wvel), (eul, weul)):
            close(g, w, ATOL, what=f"step {k} outputs")
    got = tekf.ekf_update_with_opti(st.replace(x=t(x_seam)), t(OPTI_POS),
                                    t(eul_seam))
    close_tree(got, fused, ATOL, "mocap")
    # the seam: yaw moves toward pi, not through zero
    assert float(got.x[0, 8]) > 3.1
    assert torch.equal(tekf.get_state(got), got.x)
    # float32 stays float32 through the Jacobians (the card's dtype)
    st32 = tekf.ekf_init(t(QUAT).float(), t(POS).float(), t(FPR).float())
    m = MEAS[0]
    st32, *outs = tekf.ekf_update(st32, DT, *(t(m[k]).float() for k in (
        "acc", "gyro", "fpr", "fvr", "c")))
    assert all(a.dtype == torch.float32 for a in (st32.x, st32.P, *outs))
    close(st32.x, trace[1][0].x, 1e-4, what="float32 step")


@functools.lru_cache(maxsize=None)
def _jax_feedback():
    """A standing A1 batch (JAX controller_init + sim_init) and three
    feedback_update(kf_type=2) calls on sensors drawn from a seed, each
    with a mocap pose; returns the initial state, the sensors and the
    three results."""
    p = ja1(F64)
    loop = jax.vmap(lambda h: jstep.LoopState(
        controller=jstep.controller_init(p, dtype=F64),
        sim=jsim.sim_init(p, height=h, dtype=F64)))(jnp.full((B,), 0.3))
    rng = np.random.default_rng(5)
    raws = []
    for k in range(3):
        raw = {k2: np.asarray(v) for k2, v in jax.vmap(
            lambda s: jsim.read_sensors(s, p))(loop.sim).items()}
        raw["imu_acc"] = raw["imu_acc"] + rng.normal(scale=0.2, size=(B, 3))
        raw["imu_ang_vel"] = rng.normal(scale=0.2, size=(B, 3))
        raw["joint_pos"] = raw["joint_pos"] + rng.normal(scale=0.02,
                                                         size=(B, 12))
        raw["joint_vel"] = rng.normal(scale=0.3, size=(B, 12))
        raw["foot_force_sensor"] = rng.uniform(0.0, 60.0, size=(B, 4))
        raw["mocap_pos"] = raw["pos"] + rng.normal(scale=1e-3, size=(B, 3))
        raw["mocap_euler"] = rng.normal(scale=1e-2, size=(B, 3))
        raws.append(raw)
    fb = jax.jit(jax.vmap(lambda cs, raw: jstep.feedback_update(
        cs, raw, p, DT, kf_type=2)))
    cs, out = loop.controller, []
    for raw in raws:
        cs = fb(cs, raw)
        out.append(np_tree(cs))
    return np_tree(loop), raws, out


def test_feedback_update_kf2_matches_jax():
    loop0, raws, want = _jax_feedback()
    tp = params_from_numpy(params_mapping(ja1(F64)))
    cs0 = loop_state_from_numpy(loop0).controller
    assert not bool(cs0.ekf.initialized.any())
    cs, root = cs0, []
    for k, raw in enumerate(raws):
        cs = tstep.feedback_update(cs, {n: t(v) for n, v in raw.items()},
                                   tp, DT, kf_type=2)
        close_tree(cs.ekf, want[k].ekf, ATOL, f"ekf call {k}")
        close_tree(cs.fbk, want[k].fbk, ATOL, f"fbk call {k}")
        close_tree(cs.ctrl, want[k].ctrl, ATOL, f"ctrl call {k}")
        assert bool(cs.ekf.initialized.all())
        root.append(cs.fbk.root_pos)
    # the first call initializes and keeps the root state; the later ones
    # step the filter, pulled toward the mocap pose: without the mocap keys
    # the same step lands farther from it
    assert torch.equal(root[0], cs0.fbk.root_pos)
    assert not torch.equal(root[1], root[0])
    first = tstep.feedback_update(
        cs0, {n: t(v) for n, v in raws[0].items()}, tp, DT, kf_type=2)
    bare = {n: t(v) for n, v in raws[1].items() if not n.startswith("mocap")}
    unfused = tstep.feedback_update(first, bare, tp, DT, kf_type=2)
    mocap = t(raws[1]["mocap_pos"])
    assert float((root[1] - mocap).abs().sum()) < float(
        (unfused.fbk.root_pos - mocap).abs().sum())


KF2_B, KF2_STAND, KF2_WALK = 4, 3, 3
KF2_SETTING = dict(horizon=10, n_ticks=KF2_STAND + KF2_WALK, pdip_iters=10,
                   walk_velx=0.25, stand_ticks=KF2_STAND, kf_type=2)


@functools.lru_cache(maxsize=None)
def _jax_kf2_rollout():
    p = jgo1(F64)
    loop = jrunner.init_loop_batch(p, KF2_B, jax.random.PRNGKey(17),
                                   dtype=F64, body_height=0.28,
                                   height_range=(0.26, 0.30))
    roll = jax.jit(jrunner.make_batched_rollout(
        jgait.trot_pattern(F64), solver="riccati", backend="xla",
        **KF2_SETTING))
    final, (pos, vel) = roll(loop, p)
    return np_tree(loop), np_tree(final), np.asarray(pos), np.asarray(vel)


def test_kf2_batched_rollout_matches_jax():
    loop0, final, pos, vel = _jax_kf2_rollout()
    roll = trunner.make_batched_rollout(
        tgait.trot_pattern(torch.float64, CPU), **KF2_SETTING)
    got, (gpos, gvel) = roll(loop_state_from_numpy(loop0),
                             params_from_numpy(params_mapping(jgo1(F64))))
    close(gpos, pos, 1e-6, what="pos")
    close(gvel, vel, 1e-6, what="vel")
    close_tree(got.controller.ekf, final.controller.ekf, 1e-6, "ekf")
    close(got.controller.fbk.root_euler, final.controller.fbk.root_euler,
          1e-6, what="filtered euler")
    # the batch trots and the estimate follows the truth
    assert float(gpos[-1, :, 0].min()) > 0.0
    assert float((got.controller.fbk.root_pos - got.sim.pos).abs().max()) \
        < 5e-3


SINGLE_STAND, SINGLE_WALK = 2, 2


def _mocap(pos, quat, rng, so3, xp):
    """Simulated mocap: the true pose with 1 mm / 1 mrad noise."""
    n1, n2 = rng.normal(0, 1e-3, 3), rng.normal(0, 1e-3, 3)
    return pos + xp.asarray(n1), so3.quat_to_euler(quat) + xp.asarray(n2)


@functools.lru_cache(maxsize=None)
def _jax_single_kf2():
    p = ja1(F64)
    pattern = jgait.trot_pattern(F64)
    loop = jstep.LoopState(
        controller=jstep.controller_init(p, dtype=F64),
        sim=jsim.sim_init(p, height=0.3, dtype=F64))
    init = np_tree(loop)
    fb = jax.jit(lambda cs, raw: jstep.feedback_update(cs, raw, p, DT,
                                                       kf_type=2))
    rng = np.random.default_rng(0)
    rec = []
    for k in range(SINGLE_STAND + SINGLE_WALK):
        if k == SINGLE_STAND:
            cs = loop.controller
            loop = loop.replace(controller=cs.replace(
                ctrl=cs.ctrl.replace(movement_mode=jnp.ones((), jnp.int32)),
                joy=cs.joy.replace(velx=jnp.asarray(0.2, F64))))
        raw = jsim.read_sensors(loop.sim, p)
        raw["foot_force_sensor"] = jnp.where(loop.sim.contact, 40.0,
                                             0.0).astype(F64)
        raw["mocap_pos"], raw["mocap_euler"] = _mocap(
            loop.sim.pos, loop.sim.quat, rng, jso3, jnp)
        loop = loop.replace(controller=fb(loop.controller, raw))
        loop = jstep.closed_loop_tick(loop, p, pattern, horizon=5,
                                      kf_type=2, pdip_iters=10)
        rec.append((np.asarray(loop.sim.pos), np.asarray(loop.sim.vel),
                    np.asarray(loop.controller.fbk.root_pos),
                    np.asarray(loop.controller.fbk.root_euler)))
    return init, rec


def test_single_robot_kf2_mocap_tick_matches_jax():
    init, rec = _jax_single_kf2()
    tp = params_from_numpy(params_mapping(ja1(F64)))
    pattern = tgait.trot_pattern(torch.float64, CPU)
    loop = loop_state_from_numpy(jax.tree.map(lambda x: x[None], init))
    rng = np.random.default_rng(0)
    for k in range(SINGLE_STAND + SINGLE_WALK):
        if k == SINGLE_STAND:
            cs = loop.controller
            loop = loop.replace(controller=cs.replace(
                ctrl=cs.ctrl.replace(movement_mode=torch.ones_like(
                    cs.ctrl.movement_mode)),
                joy=cs.joy.replace(velx=torch.full_like(cs.joy.velx, 0.2))))
        raw = tsim.read_sensors(loop.sim, tp)
        raw["foot_force_sensor"] = torch.where(
            loop.sim.contact, 40.0, 0.0).to(torch.float64)
        raw["mocap_pos"], raw["mocap_euler"] = _mocap(
            loop.sim.pos, loop.sim.quat, rng, tso3, torch)
        loop = loop.replace(controller=tstep.feedback_update(
            loop.controller, raw, tp, DT, kf_type=2))
        loop = tstep.closed_loop_tick(loop, tp, pattern, horizon=5,
                                      kf_type=2, pdip_iters=10)
        for got, want, name in zip(
                (loop.sim.pos, loop.sim.vel, loop.controller.fbk.root_pos,
                 loop.controller.fbk.root_euler), rec[k],
                ("pos", "vel", "estimated pos", "estimated euler")):
            close(got[0], want, 1e-6, what=f"{name} tick {k}")
    assert isinstance(loop.controller.ekf, EkfState)
