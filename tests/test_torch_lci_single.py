"""PyTorch port vs the JAX package: the single-robot LCI path, in float64
from the same JAX initial states.

  * `lci_init` and `lci_mpc_tick` (the B=1 view of the batched seam): the
    x40 layout with its 2-tap filters, the policy clock that advances in a
    mode and resets on a switch, the optimized state and input: 1e-8;
    `lci_state_from_numpy` gives an unbatched JAX state its leading axis;
  * `make_walk_policy` (the `--mpc lci` trot) at three states in one
    batch-first call, one with a clock-stance foot still unloaded (the
    bootstrap push), against JAX's unbatched policy: 1e-8;
  * `step.closed_loop_tick_lci`, 3 ticks each: the convex walk from a
    standing start, and `ci_mpc.make_ci_walk_policy` at 4 sweeps with the
    policy clock 3 ms off a tick (ROADMAP fault 7);
  * `step.closed_loop_tick_lci_wb`, 2 ticks of the A1 wall lean of
    tests/test_ci_wall_lean.py at 4 sweeps, on the articulated twin.
Tick states agree within 1e-8 (positions, velocities, the optimized input,
the warm slot). Every JAX function is compiled once (XLA:CPU's compile
count, pytest.ini)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu.config import a1_params as ja1
from legged_mpc_control_tpu.control import step as jstep
from legged_mpc_control_tpu.models import kinematics as jkin
from legged_mpc_control_tpu.models import whole_body as jwb
from legged_mpc_control_tpu.mpc import ci_mpc as jci
from legged_mpc_control_tpu.mpc import lci_mpc as jlci
from legged_mpc_control_tpu.sim import srb_sim as jsim
from legged_mpc_control_tpu.sim import terrain as jterr
from legged_mpc_control_tpu.sim import wb_sim as jwbs
from legged_mpc_control_tpu_torch.config import params_from_numpy
from legged_mpc_control_tpu_torch.control import step as tstep
from legged_mpc_control_tpu_torch.models import whole_body as twb
from legged_mpc_control_tpu_torch.mpc import ci_mpc as tci
from legged_mpc_control_tpu_torch.mpc import lci_mpc as tlci
from legged_mpc_control_tpu_torch.ops import cuda_build
from legged_mpc_control_tpu_torch.sim import terrain as tterr
from legged_mpc_control_tpu_torch.tree import from_numpy
from legged_mpc_control_tpu_torch.types import (
    ControllerState,
    loop_state_from_numpy,
    wb_loop_state_from_numpy,
)
from torch_parity import close, np_tree, params_mapping, t

F64 = jnp.float64
JP = ja1(F64)
TP = params_from_numpy(params_mapping(JP))
PITCH, WALL_X = -0.4, 0.35
TICKS, WB_TICKS, CI_ITERS = 3, 2, 4
JSTAND = jlci.make_stand_policy(JP, body_height=0.3)
JWALK = jlci.make_walk_policy(JP, velx=0.25, body_height=0.3)
JCI = jci.make_ci_walk_policy(JP, velx=0.1, iters=CI_ITERS)
TSTAND = tlci.make_stand_policy(TP, body_height=0.3)
TWALK = tlci.make_walk_policy(TP, velx=0.25, body_height=0.3)
TCI = tci.make_ci_walk_policy(TP, velx=0.1, iters=CI_ITERS)


def _mode(loop, xp, mode=1):
    cs = loop.controller
    return loop.replace(controller=cs.replace(ctrl=cs.ctrl.replace(
        movement_mode=xp.full_like(cs.ctrl.movement_mode, mode))))


def _srb_start():
    return jstep.LoopState(
        controller=jstep.controller_init(JP, dtype=F64),
        sim=jsim.sim_init(JP, height=0.3, dtype=F64))


def _sensed():
    """A standing controller with the feet's forces read (the JAX test's
    `_controller_with_sensors`)."""
    sim = jsim.sim_init(JP, height=0.3, dtype=F64)
    raw = jsim.read_sensors(sim, JP)
    raw["foot_force_sensor"] = jnp.array([30.0, 0.0, 28.0, 31.0], F64)
    return jstep.feedback_update(jstep.controller_init(JP, dtype=F64), raw,
                                 JP, 0.00125, kf_type=0)


def _port_controller(cs):
    """A JAX ControllerState of one robot as the port's batch of one."""
    return from_numpy(ControllerState, jax.tree.map(lambda x: x[None],
                                                    np_tree(cs)))


def _lean():
    """tests/test_ci_wall_lean.py:41-73's A1 setup in float64: params,
    the lean pose, the policy, the twin's state and the warmed filter."""
    jp = JP.replace(mu=jnp.asarray(0.6, F64))
    model = jwb.wb_model_for("a1")
    wall = jterr.wall_at_x(WALL_X, dtype=F64)
    pos = jnp.array([0.0, 0.0, 0.32], F64)
    feet_tgt = jnp.array([[WALL_X, 0.13, 0.42], [WALL_X, -0.13, 0.42],
                          [-0.17, 0.13, 0.0], [-0.17, -0.13, 0.0]], F64)
    feet_w = feet_tgt.at[0:2, 0].add(-0.0015)
    cp, sp = jnp.cos(PITCH), jnp.sin(PITCH)
    R = jnp.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]], F64)
    qj = jkin.ik_legs((feet_w - pos[None]) @ R,
                      jnp.tile(jnp.array([0.0, 0.8, -1.6], F64), (4, 1)),
                      jwbs.wb_rho_fix(model, F64))
    q0 = jnp.concatenate([pos, jnp.array([0.0, PITCH, 0.0], F64),
                          qj.reshape(-1)])
    sim = jwbs.WbSimState(q=q0, v=jnp.zeros(18, F64),
                          anchor=jwb.foot_positions(q0, model)[:, :2],
                          wall_anchor=jwb.foot_positions(q0, model),
                          f_contact=jnp.zeros((4, 3), F64),
                          last_acc=jnp.zeros(3, F64))
    lean = jci.make_ci_lean_policy(jp, wall, feet_tgt, pos,
                                   jnp.array([0.0, PITCH, 0.0], F64),
                                   terrain=jterr.flat(dtype=F64),
                                   iters=CI_ITERS)
    loop = _mode(jstep.LoopState(controller=jstep.controller_init(
        jp, dtype=F64), sim=sim), jnp)
    lci = jlci.lci_init(dtype=F64, policy_warm=lean.warm_init(F64)).replace(
        prev_foot_pos=feet_w - pos[None], prev_foot_vel=jnp.zeros((4, 3),
                                                                  F64))
    return dict(jp=jp, model=model, wall=wall, lean=lean, loop=loop,
                lci=lci, pose=(feet_tgt, pos))


def _record(loop, lci):
    sim = loop.sim
    pos = sim.q[..., 0:3] if hasattr(sim, "q") else sim.pos
    vel = sim.v if hasattr(sim, "v") else sim.vel
    rec = [np.array(pos), np.array(vel),
           np.array(loop.controller.ctrl.optimized_input),
           np.array(lci.policy_time)]
    if lci.policy_warm is not None:
        rec.append(np.array(lci.policy_warm["u"]))
    return rec


@functools.lru_cache(maxsize=None)
def _jax_ticks(name):
    """JAX's jitted single-robot LCI tick over the recipe `name`: the
    initial (loop, lci) and the record after every tick."""
    if name == "lean":
        L = _lean()
        loop, lci = L["loop"], L["lci"]
        tick = jax.jit(lambda lp, lc, tt: jstep.closed_loop_tick_lci_wb(
            lp, lc, L["jp"], L["model"], JSTAND, L["lean"], tt,
            terrain=jterr.flat(dtype=F64), wall=L["wall"]))
        n = WB_TICKS
    else:
        loop = _mode(_srb_start(), jnp)
        walk = JWALK if name == "convex" else JCI
        warm = None if name == "convex" else JCI.warm_init(F64)
        lci = jlci.lci_init(dtype=F64, policy_warm=warm)
        if name == "ci":
            lci = lci.replace(prev_mode=jnp.ones((), jnp.int32),
                              policy_time=jnp.asarray(0.003, F64))
        tick = jax.jit(lambda lp, lc, tt, _w=walk:
                       jstep.closed_loop_tick_lci(lp, lc, JP, JSTAND, _w,
                                                  tt))
        n = TICKS
    init, rec = (np_tree(loop), np_tree(lci)), []
    for k in range(n):
        loop, lci = tick(loop, lci, jnp.asarray(0.01 * k, F64))
        rec.append(_record(loop, lci))
    return init, rec


def _port_state(init, wb=False):
    jloop, jlci_ = init
    loop = (wb_loop_state_from_numpy if wb else loop_state_from_numpy)(
        jax.tree.map(lambda x: x[None], jloop))
    return loop, tlci.lci_state_from_numpy(jlci_)


def _check_ticks(rec_t, rec_j, what):
    names = ("pos", "vel", "optimized_input", "policy_time", "warm u")
    for k, (got, want) in enumerate(zip(rec_t, rec_j)):
        for name, g, w in zip(names, got, want):
            g = g[0] if name != "warm u" else g
            close(g, w, 1e-8, what=f"{what} tick {k} {name}")


def test_lci_state_converter_and_init():
    jl = jlci.lci_init(dtype=F64, policy_warm=JCI.warm_init(F64)).replace(
        prev_foot_pos=jnp.arange(12, dtype=F64).reshape(4, 3),
        policy_time=jnp.asarray(0.4, F64), prev_mode=jnp.ones((), jnp.int32))
    s = tlci.lci_state_from_numpy(np_tree(jl))
    assert s.prev_foot_pos.shape == (1, 4, 3)
    assert s.policy_time.shape == (1,) and s.prev_mode.shape == (1,)
    assert s.policy_warm["u"].shape == (10, 24)
    assert s.policy_warm["valid"].shape == ()
    close(s.prev_foot_pos[0], np.asarray(jl.prev_foot_pos), 0.0)
    back = tlci.lci_state_to_numpy(s)
    assert back["policy_time"].shape == (1,)
    # a batched JAX state keeps its shapes
    jb = jlci.lci_init_batched(3, dtype=F64)
    assert tlci.lci_state_from_numpy(np_tree(jb)).prev_foot_pos.shape == (
        3, 4, 3)
    z = tlci.lci_init(torch.float64, TCI.warm_init(torch.float64, "cpu"),
                      device="cpu")
    assert z.prev_foot_pos.shape == (1, 4, 3) and z.prev_mode.dtype == (
        torch.int32)
    assert z.policy_warm["u"].shape == (10, 24)


def test_lci_mpc_tick_layout_and_clock():
    """The x40 packing and the seam's outputs, with the clock advancing in
    a mode and reset by a switch (LciMpc.cpp:46-92)."""
    cs = _sensed()
    prev = jnp.arange(12, dtype=F64).reshape(4, 3) * 0.01
    jl = jlci.lci_init(dtype=F64).replace(prev_foot_pos=prev,
                                          policy_time=jnp.asarray(3.7, F64))
    tick = jax.jit(lambda c, l: jlci.lci_mpc_tick(c, l, JSTAND, JWALK, 0.0,
                                                  0.01))
    want = []
    for mode in (0, 1):
        jcs = cs.replace(ctrl=cs.ctrl.replace(
            movement_mode=jnp.asarray(mode, jnp.int32)))
        jc2, jl2 = tick(jcs, jl)
        want.append((jc2, jl2))
    tcs = _port_controller(cs)
    tl = tlci.lci_state_from_numpy(np_tree(jl))
    x, fp, _ = tlci.pack_policy_state(tcs.fbk, tl)
    jx, jfp, _ = jlci.pack_policy_state(cs.fbk, jl)
    assert x.shape == (1, 40)
    close(x[0], np.asarray(jx), 1e-12)
    close(fp[0], np.asarray(jfp), 1e-12)
    for mode, (jc2, jl2) in zip((0, 1), want):
        tc = tcs.replace(ctrl=tcs.ctrl.replace(
            movement_mode=torch.full((1,), mode, dtype=torch.int32)))
        c2, l2 = tlci.lci_mpc_tick(tc, tl, TSTAND, TWALK, 0.0, 0.01)
        close(c2.ctrl.optimized_state[0],
              np.asarray(jc2.ctrl.optimized_state), 1e-8)
        close(c2.ctrl.optimized_input[0],
              np.asarray(jc2.ctrl.optimized_input), 1e-8)
        close(l2.policy_time[0], np.asarray(jl2.policy_time), 1e-12)
        close(l2.prev_foot_pos[0], np.asarray(jl2.prev_foot_pos), 0.0)
        assert bool(c2.mpc_inited.all())
    # same mode: the clock advances; a switch resets it
    assert abs(float(want[0][1].policy_time) - 3.71) < 1e-12
    assert float(want[1][1].policy_time) == 0.0
    two = from_numpy(ControllerState, jax.tree.map(
        lambda x: np.stack([x, x]), np_tree(cs)))
    with pytest.raises(ValueError, match="one robot"):
        tlci.lci_mpc_tick(two, tlci.lci_init_batched(2, torch.float64,
                                                     device="cpu"),
                          TSTAND, TWALK, 0.0, 0.01)


def test_walk_policy_states():
    """`make_walk_policy` at three states in one batch-first call: a
    standing robot mid-stride, a perturbed one moving, and one whose
    clock-stance foot is still unloaded (the bootstrap push)."""
    cs = _sensed()
    x0, _, _ = jlci.pack_policy_state(cs.fbk, jlci.lci_init(dtype=F64))
    rng = np.random.default_rng(4)
    X = np.stack([np.asarray(x0)] * 3)
    X[1, 0:6] += 0.01 * rng.normal(size=6)
    X[1, 18:24] += [0.2, 0.02, -0.05, 0.1, -0.1, 0.05]
    # at t = 0.05 s (phase 0.175 at 3.5 Hz) FL and RR are in clock stance:
    # RR reads no force yet
    X[2, 36:40] = [31.0, 25.0, 0.0, 0.0]
    T = np.array([0.1, 0.37, 0.05])
    want = np.asarray(jax.jit(jax.vmap(JWALK))(jnp.asarray(X),
                                               jnp.asarray(T)))
    got = TWALK(t(X), t(T))
    assert got.shape == (3, 78)
    close(got, want, 1e-8)
    # the unloaded clock-stance foot gets the bootstrap push 2 fz_min down
    assert float(got[2, 11]) == 10.0 and float(got[2, 9]) == 0.0
    assert float(got[0, 2:12:3].sum()) > 0.3 * 9.8 * float(TP.mass)


@pytest.mark.parametrize("name", ["convex", "ci"])
def test_closed_loop_tick_lci(name):
    init, rec = _jax_ticks(name)
    loop, lci = _port_state(init)
    walk = TWALK if name == "convex" else TCI
    cuda_build.LAUNCHES.clear()
    got = []
    for k in range(TICKS):
        loop, lci = tstep.closed_loop_tick_lci(loop, lci, TP, TSTAND, walk,
                                               0.01 * k)
        got.append(_record(loop, lci))
    _check_ticks(got, rec, name)
    assert sum(cuda_build.LAUNCHES.values()) == 0


def test_closed_loop_tick_lci_wb_lean():
    init, rec = _jax_ticks("lean")
    L = _lean()
    loop, lci = _port_state(init, wb=True)
    tp = params_from_numpy(params_mapping(L["jp"]))
    model = twb.wb_model_from_numpy(np_tree(L["model"]), dtype=torch.float64)
    wall = tterr.wall_from_numpy(np_tree(L["wall"]))
    feet_tgt, pos = L["pose"]
    lean = tci.make_ci_lean_policy(
        tp, wall, t(feet_tgt), t(pos),
        torch.tensor([0.0, PITCH, 0.0], dtype=torch.float64),
        iters=CI_ITERS)
    got = []
    for k in range(WB_TICKS):
        loop, lci = tstep.closed_loop_tick_lci_wb(loop, lci, tp, model,
                                                  TSTAND, lean, 0.01 * k,
                                                  wall=wall)
        got.append(_record(loop, lci))
    _check_ticks(got, rec, "lean")
    # the front feet press the wall
    assert float(-loop.sim.f_contact[0, 0:2, 0].min()) > 0.0
