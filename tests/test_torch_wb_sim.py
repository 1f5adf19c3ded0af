"""The port's articulated twin (`sim/wb_sim.py`) and its ticks against the
JAX package, on the CPU:

- `wb_sim_init` on flat ground and standing on a box; the ground and wall
  contact forces on seeded feet (penetrating, free, sliding); and
  `wb_read_sensors`: float64 within 1e-10.
- One control period (n_inner 4) of `wb_sim_step` against JAX's autodiff
  `wb_sim_step`, with a wall the front feet press into, and of
  `wb_sim_step_batched` against JAX's (backend "xla", an LU solve where the
  port factors with K4 + K5's plain versions): float64 within 1e-9.
- `closed_loop_tick_wb_batched`, A1 (kp_foot 40, kd_foot 1.2), B=3, one
  standing and two walking ticks (the command as `make_batched_rollout_wb`
  sets it), riccati and pdip, float64: q within 1e-6, v within 1e-5 at
  every tick; riccati in float32 within the JAX package's own
  batched-vs-per-scenario tolerances (tests/test_wb_batched.py:44-47: 1e-4
  on q, 1e-3 on v). The riccati cases run through the port's
  `make_batched_rollout_wb`.

Every JAX function is compiled once (XLA:CPU's compile count, pytest.ini)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu.config import a1_params as ja1
from legged_mpc_control_tpu.control import step as jstep
from legged_mpc_control_tpu.models import whole_body as jwb
from legged_mpc_control_tpu.mpc import gait as jgait
from legged_mpc_control_tpu.parallel import runner as jrunner
from legged_mpc_control_tpu.sim import terrain as jterr
from legged_mpc_control_tpu.sim import wb_sim as jwbs
from legged_mpc_control_tpu_torch.config import params_from_numpy
from legged_mpc_control_tpu_torch.control import step as tstep
from legged_mpc_control_tpu_torch.models import whole_body as twb
from legged_mpc_control_tpu_torch.mpc import gait as tgait
from legged_mpc_control_tpu_torch.ops import cuda_build
from legged_mpc_control_tpu_torch.parallel import runner as trunner
from legged_mpc_control_tpu_torch.sim import terrain as tterr
from legged_mpc_control_tpu_torch.sim import wb_sim as twbs
from legged_mpc_control_tpu_torch.tree import from_numpy
from legged_mpc_control_tpu_torch.types import wb_loop_state_from_numpy
from torch_parity import close, close_tree, np_tree, params_mapping, t

F64, F32 = jnp.float64, jnp.float32
CPU = torch.device("cpu")
B = 3
DT = 0.00125
JMODEL = jwb.a1_wb_model()
BOX = dict(center_xy=(0.0, 0.0), size_xy=(1.0, 1.0), height=0.03)
STAND, WALK, VELX = 1, 2, 0.2


def _jparams(dtype):
    return ja1(dtype).replace(kp_foot=jnp.full(3, 40.0, dtype),
                              kd_foot=jnp.full(3, 1.2, dtype))


def _tparams(dtype):
    jd = F64 if dtype == torch.float64 else F32
    return params_from_numpy(params_mapping(_jparams(jd)))


def _tmodel(dtype=torch.float64):
    return twb.wb_model_from_numpy(JMODEL, dtype=dtype)


def _box(xp_terrain, dtype, **kw):
    return xp_terrain.add_box(xp_terrain.flat(extent=1.0, cell=0.05,
                                              dtype=dtype, **kw), **BOX)


@functools.lru_cache(maxsize=None)
def _jax_init():
    p = _jparams(F64)
    heights = jnp.asarray([0.27, 0.28, 0.30], F64)
    init = jax.jit(jax.vmap(lambda h, ter: jwbs.wb_sim_init(
        JMODEL, p, height=h, dtype=F64, terrain=ter), in_axes=(0, None)))
    return (np.asarray(heights), np_tree(init(heights, None)),
            np_tree(init(heights, _box(jterr, F64))))


def test_wb_sim_init_matches_jax():
    heights, flat, boxed = _jax_init()
    p, m = _tparams(torch.float64), _tmodel()
    for terrain, want in ((None, flat),
                          (_box(tterr, torch.float64, device="cpu"), boxed)):
        got = twbs.wb_sim_init(m, p, t(heights), torch.float64, "cpu",
                               terrain=terrain)
        close_tree(got, want, 1e-10, "init")
    # on the box the trunk stands 3 cm higher
    close(got.q[:, 2], heights + 0.03, 1e-12)


def _feet_batch(seed):
    """Seeded feet around the ground (some penetrating, some free), their
    velocities and anchors, and per-scenario friction."""
    rng = np.random.default_rng(seed)
    feet = rng.normal(scale=0.1, size=(B, 4, 3))
    feet[..., 2] = rng.uniform(-0.004, 0.003, size=(B, 4))
    vfeet = rng.normal(scale=0.3, size=(B, 4, 3))
    anchor = feet[..., :2] + rng.normal(scale=0.002, size=(B, 4, 2))
    wall_anchor = feet + rng.normal(scale=0.002, size=(B, 4, 3))
    mu = rng.uniform(0.4, 1.0, size=B)
    return feet, vfeet, anchor, wall_anchor, mu


@functools.lru_cache(maxsize=None)
def _jax_contacts():
    feet, vfeet, anchor, wall_anchor, mu = _feet_batch(1)
    box = _box(jterr, F64)
    wall = jterr.wall_at_x(0.05, dtype=F64)
    ground = jax.jit(jax.vmap(lambda f, v, a, m, ter: jwbs._contact_forces(
        f, v, a, m, ter, F64), in_axes=(0, 0, 0, 0, None)))
    walls = jax.jit(jax.vmap(lambda f, v, a, m: jwbs._wall_contact_forces(
        f, v, a, m, wall, F64)))
    out = (ground(feet, vfeet, anchor, mu, None),
           ground(feet, vfeet, anchor, mu, box),
           walls(feet, vfeet, wall_anchor, mu))
    return jax.tree.map(np.asarray, out)


def test_contact_and_wall_forces_match_jax():
    flat, boxed, walled = _jax_contacts()
    feet, vfeet, anchor, wall_anchor, mu = (t(a) for a in _feet_batch(1))
    box = _box(tterr, torch.float64, device="cpu")
    wall = tterr.wall_at_x(0.05, dtype=torch.float64, device="cpu")
    for terrain, want in ((None, flat), (box, boxed)):
        f, a = twbs._contact_forces(feet, vfeet, anchor, mu, terrain)
        close(f, want[0], 1e-10, what="ground force")
        close(a, want[1], 1e-10, what="anchor")
    f, a = twbs._wall_contact_forces(feet, vfeet, wall_anchor, mu, wall)
    close(f, walled[0], 1e-10, what="wall force")
    close(a, walled[1], 1e-10, what="wall anchor")
    # the cases the draw is for: feet in and out of contact, and the
    # friction cap reached
    fn = flat[0][..., 2]
    assert (fn > 0).any() and (fn == 0).any()
    ft = np.linalg.norm(flat[0][..., :2], axis=-1)
    assert np.isclose(ft, mu.numpy()[:, None] * fn).any()
    assert (np.abs(walled[0][..., 0]) > 0).any()


def _perturbed_state(seed):
    """The twin's standing batch with seeded joint and trunk motion, and
    seeded torques."""
    _, flat, _ = _jax_init()
    rng = np.random.default_rng(seed)
    s = flat.replace(
        q=flat.q + rng.normal(scale=0.01, size=(B, 18)),
        v=rng.normal(scale=0.3, size=(B, 18)))
    tau = rng.normal(scale=8.0, size=(B, 12))
    return s, tau


WALL_X = 0.165      # the front feet (x ~0.16-0.18) press into it


@functools.lru_cache(maxsize=None)
def _jax_steps():
    s, tau = _perturbed_state(2)
    p = _jparams(F64)
    pb = jstep.broadcast_params(p, B)
    wall = jterr.wall_at_x(WALL_X, dtype=F64)
    autodiff = jax.jit(jax.vmap(lambda ss, tt: jwbs.wb_sim_step(
        ss, tt, JMODEL, p, DT, n_inner=4, wall=wall)))(s, tau)
    batched = jax.jit(lambda ss, tt: jwbs.wb_sim_step_batched(
        ss, tt, JMODEL, pb, DT, n_inner=4, backend="xla"))(s, tau)
    sensors = jax.jit(jax.vmap(lambda ss: jwbs.wb_read_sensors(
        ss, JMODEL)))(batched)
    return (np_tree(s), tau, np_tree(autodiff), np_tree(batched),
            {k: np.asarray(v) for k, v in sensors.items()})


def test_wb_sim_step_matches_jax():
    s, tau, autodiff, batched, _ = _jax_steps()
    p, m = _tparams(torch.float64), _tmodel()
    state = from_numpy(twbs.WbSimState, s)
    wall = tterr.wall_at_x(WALL_X, dtype=torch.float64, device="cpu")
    cuda_build.LAUNCHES.clear()
    got = twbs.wb_sim_step_batched(state, t(tau), m,
                                   tstep.broadcast_params(p, B), DT,
                                   n_inner=4, wall=wall)
    close_tree(got, autodiff, 1e-9, "against the autodiff step, walled")
    got = twbs.wb_sim_step_batched(state, t(tau), m,
                                   tstep.broadcast_params(p, B), DT,
                                   n_inner=4)
    close_tree(got, batched, 1e-9, "against the batched step")
    # one robot is a batch of one
    one = twbs.wb_sim_step(from_numpy(twbs.WbSimState, jax.tree.map(
        lambda x: x[:1], s)), t(tau[:1]), m, p, DT, n_inner=4)
    close(one.q, got.q[:1], 1e-12)
    # the wall pushed on the front feet in the walled step
    assert not np.allclose(autodiff.f_contact[:, :2], batched.f_contact[:, :2])
    assert sum(cuda_build.LAUNCHES.values()) == 0


def test_wb_read_sensors_matches_jax():
    _, _, _, batched, want = _jax_steps()
    got = twbs.wb_read_sensors(from_numpy(twbs.WbSimState, batched),
                               _tmodel())
    assert got.keys() == want.keys()
    for k in got:
        if got[k].dtype == torch.bool:
            assert np.array_equal(got[k].numpy(), want[k]), k
        else:
            close(got[k], want[k], 1e-10, what=k)


@functools.lru_cache(maxsize=None)
def _jax_ticks(solver, dtype_name):
    """JAX's closed_loop_tick_wb_batched over STAND + WALK ticks, the
    command as make_batched_rollout_wb sets it: the initial state and
    (q, v) after every tick."""
    dtype = {"f64": F64, "f32": F32}[dtype_name]
    p = _jparams(dtype)
    loop = jrunner.init_wb_loop_batch(p, JMODEL, B, jax.random.PRNGKey(0),
                                      dtype=dtype)
    pb = jstep.broadcast_params(p, B)
    tick = jax.jit(lambda lp, w: jstep.closed_loop_tick_wb_batched(
        lp, pb, jgait.trot_pattern(dtype), JMODEL, horizon=10, iters=8,
        solver=solver, backend="xla", warm=w))
    init, rec = np_tree(loop), []
    warm = jnp.zeros((B, 120), dtype)
    for k in range(STAND + WALK):
        cs = loop.controller
        loop = loop.replace(controller=cs.replace(
            ctrl=cs.ctrl.replace(movement_mode=jnp.full(
                (B,), int(k >= STAND), jnp.int32)),
            joy=cs.joy.replace(velx=jnp.full((B,), VELX, dtype))))
        loop, warm = tick(loop, warm)
        rec.append((np.asarray(loop.sim.q), np.asarray(loop.sim.v)))
    return init, rec


TICK_CASES = {("riccati", "f64"): (1e-6, 1e-5), ("pdip", "f64"): (1e-6, 1e-5),
              ("riccati", "f32"): (1e-4, 1e-3)}


@pytest.mark.parametrize("solver,dtype_name", sorted(TICK_CASES))
def test_wb_batched_tick_matches_jax(solver, dtype_name):
    init, rec = _jax_ticks(solver, dtype_name)
    tol_q, tol_v = TICK_CASES[(solver, dtype_name)]
    dtype = {"f64": torch.float64, "f32": torch.float32}[dtype_name]
    loop = wb_loop_state_from_numpy(init)
    p, m = _tparams(dtype), _tmodel(dtype)
    pattern = tgait.trot_pattern(dtype, CPU)
    if solver == "riccati":
        # through the runner: its trajectory is the ticks'
        roll = trunner.make_batched_rollout_wb(
            pattern, m, horizon=10, n_ticks=STAND + WALK, pdip_iters=8,
            walk_velx=VELX, solver=solver, stand_ticks=STAND)
        final, (pos, vel) = roll(loop, p)
        for k in range(STAND + WALK):
            close(pos[k], rec[k][0][:, 0:3], tol_q, what=f"pos tick {k}")
            close(vel[k], rec[k][1][:, 0:3], tol_v, what=f"vel tick {k}")
        close(final.sim.q, rec[-1][0], tol_q, what="q")
        close(final.sim.v, rec[-1][1], tol_v, what="v")
        assert final.sim.q.dtype == dtype
        return
    pb = tstep.broadcast_params(p, B)
    warm = torch.zeros((B, 120), dtype=dtype)
    for k in range(STAND + WALK):
        cs = loop.controller
        loop = loop.replace(controller=cs.replace(
            ctrl=cs.ctrl.replace(movement_mode=torch.full(
                (B,), int(k >= STAND), dtype=torch.int32)),
            joy=cs.joy.replace(velx=torch.full((B,), VELX, dtype=dtype))))
        loop, warm = tstep.closed_loop_tick_wb_batched(
            loop, pb, pattern, m, horizon=10, iters=8, solver=solver,
            warm=warm)
        close(loop.sim.q, rec[k][0], tol_q, what=f"q tick {k}")
        close(loop.sim.v, rec[k][1], tol_v, what=f"v tick {k}")


def test_init_wb_loop_batch_draws_from_the_generator():
    p, m = _tparams(torch.float32), _tmodel(torch.float32)
    a = trunner.init_wb_loop_batch(p, m, 6, torch.Generator().manual_seed(4),
                                   device=CPU)
    b = trunner.init_wb_loop_batch(p, m, 6, torch.Generator().manual_seed(4),
                                   device=CPU)
    assert torch.equal(a.sim.q, b.sim.q) and a.sim.q.dtype == torch.float32
    z = a.sim.q[:, 2]
    assert float(z.min()) >= 0.26 and float(z.max()) <= 0.30
    assert float(z.max() - z.min()) > 0.005
    close(a.controller.joy.body_height, np.full(6, 0.28, np.float32), 0.0)
