"""The single-robot convex tick and terrain in the batched tick: the port
against the JAX package, f64 on the CPU.

- `pdip.solve_qp_pdip` on three seeded QPs from a trotting state (H=10,
  within 1e-8), and on a QP whose Newton matrix stops being positive
  definite part way: both solvers freeze on the same iteration.
- `step.closed_loop_tick`: one A1 robot, 3 standing ticks and 3 trotting
  at 0.25 m/s, for kf_type 0 and 1 on flat ground and kf_type 0 on the
  3 cm platform of `tests/test_terrain_walk.py` (positions, velocities
  and GRFs within 1e-6 at every tick). The port's robot is a batch of one.
- `step.closed_loop_tick_batched(..., terrain=)`: two A1 scenarios on the
  platform with `standing_trot`, H=30, iters=12, warm starts carried, the
  terrain-following height command, 3 standing and 3 walking ticks
  (within 1e-6 at every tick), against JAX's XLA backend.

Every JAX function is compiled once per setting (XLA:CPU's compile count,
pytest.ini)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu.config import a1_params as ja1
from legged_mpc_control_tpu.control import step as jstep
from legged_mpc_control_tpu.mpc import gait as jgait
from legged_mpc_control_tpu.mpc import pdip as jpdip
from legged_mpc_control_tpu.sim import srb_sim as jsim
from legged_mpc_control_tpu.sim import terrain as jterr
from legged_mpc_control_tpu_torch.config import params_from_numpy
from legged_mpc_control_tpu_torch.control import step as tstep
from legged_mpc_control_tpu_torch.mpc import convex_mpc as tmpc
from legged_mpc_control_tpu_torch.mpc import gait as tgait
from legged_mpc_control_tpu_torch.mpc import pdip as tpdip
from legged_mpc_control_tpu_torch.sim import terrain as tterr
from legged_mpc_control_tpu_torch.types import loop_state_from_numpy
from torch_parity import close, np_tree, params_mapping, t

F64 = jnp.float64
CPU = torch.device("cpu")
JP = ja1(F64)
TP = params_from_numpy(params_mapping(JP))
STAND, WALK = 3, 3
VELX = 0.25
PDIP_ITERS = 15
# the 3 cm platform of tests/test_terrain_walk.py
PLATFORM = jterr.add_box(jterr.flat(extent=3.0, cell=0.05, dtype=F64),
                         center_xy=(1.3, 0.0), size_xy=(2.2, 2.0),
                         height=0.03)
SINGLE = {"kf0": (0, None), "kf1": (1, None), "kf0_platform": (0, PLATFORM)}


def _walk(cs, velx, xp):
    """Walk mode and the forward command, on either package's state."""
    return cs.replace(
        ctrl=cs.ctrl.replace(movement_mode=xp.ones_like(
            cs.ctrl.movement_mode)),
        joy=cs.joy.replace(velx=xp.full_like(cs.joy.velx, velx)))


def _record(loop):
    return (np.array(loop.sim.pos), np.array(loop.sim.vel),
            np.array(loop.controller.ctrl.optimized_input[..., :12]))


@functools.lru_cache(maxsize=None)
def _jax_single(name):
    """JAX's jitted closed_loop_tick over the recipe: the initial state and
    (pos, vel, GRF) after every tick."""
    kf_type, terrain = SINGLE[name]
    loop = jstep.LoopState(
        controller=jstep.controller_init(JP, dtype=F64, body_height=0.3),
        sim=jsim.sim_init(JP, height=0.3, dtype=F64, terrain=terrain))
    init, rec = np_tree(loop), []
    for k in range(STAND + WALK):
        if k == STAND:
            loop = loop.replace(controller=_walk(loop.controller, VELX, jnp))
        loop = jstep.closed_loop_tick(loop, JP, jgait.trot_pattern(F64),
                                      horizon=10, kf_type=kf_type,
                                      terrain=terrain,
                                      pdip_iters=PDIP_ITERS)
        rec.append(_record(loop))
    return init, rec, np_tree(loop)


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_single_tick_matches_jax(name):
    init, rec, _ = _jax_single(name)
    kf_type, terrain = SINGLE[name]
    terr = None if terrain is None else tterr.terrain_from_numpy(
        np_tree(terrain))
    loop = loop_state_from_numpy(jax.tree.map(lambda x: x[None], init))
    pattern = tgait.trot_pattern(torch.float64, CPU)
    for k in range(STAND + WALK):
        if k == STAND:
            loop = loop.replace(controller=_walk(loop.controller, VELX,
                                                 torch))
        loop = tstep.closed_loop_tick(loop, TP, pattern, horizon=10,
                                      kf_type=kf_type, terrain=terr,
                                      pdip_iters=PDIP_ITERS)
        pos, vel, grf = _record(loop)
        close(pos[0], rec[k][0], 1e-6, what=f"pos tick {k}")
        close(vel[0], rec[k][1], 1e-6, what=f"vel tick {k}")
        close(grf[0], rec[k][2], 1e-6, what=f"GRF tick {k}")
    # the robot trots: a leg swings, and it moves forward
    assert not bool(loop.sim.contact.all())
    assert float(loop.sim.vel[0, 0]) > 0.0


def test_single_tick_rejects_unported():
    loop = loop_state_from_numpy(jax.tree.map(lambda x: x[None],
                                              _jax_single("kf0")[0]))
    pattern = tgait.trot_pattern(torch.float64, CPU)
    with pytest.raises(NotImplementedError):
        tstep.closed_loop_tick(loop, TP, pattern, kf_type=3)
    with pytest.raises(NotImplementedError):
        tstep.closed_loop_tick(loop, TP, pattern, low_level_type=2)


# --- the unbatched condensed PDIP ---------------------------------------

@functools.lru_cache(maxsize=None)
def _qps():
    """Four condensed QPs (H=10) of the kf0 robot after its trot, from the
    port's own prepare and condensation (their parity with JAX is
    tests/test_torch_condensed.py): three with the root velocity perturbed
    from a seed, and the first with the force of one stance foot at stage 0
    given negative curvature (P - 1e-3 e e^T), so that its Newton matrix
    stops being positive definite once that foot's constraint duals shrink
    (after three iterations; 3e-3 fails there too, 3e-4 converges)."""
    final = _jax_single("kf0")[2]
    loop = loop_state_from_numpy(jax.tree.map(
        lambda x: np.repeat(np.asarray(x)[None], 3, 0), final))
    rng = np.random.default_rng(5)
    cs = loop.controller
    cs = cs.replace(fbk=cs.fbk.replace(
        root_lin_vel=cs.fbk.root_lin_vel
        + t(rng.normal(scale=0.1, size=(3, 3)))))
    _, stage = tmpc.mpc_prepare(cs, tstep.broadcast_params(TP, 3),
                                tgait.trot_pattern(torch.float64, CPU), 0.01,
                                horizon=10)
    qp = tmpc.build_condensed_from_stage(stage, 0.01)
    leg = int(torch.nonzero(qp.contact[0, 0])[0])
    e = torch.zeros(qp.P.shape[-1], dtype=torch.float64)
    e[3 * leg + 2] = 1.0
    P = torch.cat([qp.P, (qp.P[0] - 1e-3 * torch.outer(e, e))[None]])
    q = torch.cat([qp.q, qp.q[:1]])
    return (P, q, float(qp.mu[0]), float(qp.fz_max[0]),
            torch.cat([qp.contact, qp.contact[:1]]))


@functools.lru_cache(maxsize=None)
def _jax_pdip(iters):
    return jax.jit(lambda P, q, c: jpdip.solve_qp_pdip(
        P, q, JP.mu, JP.fz_max, contact=c, iters=iters))


def _port_pdip(i, iters):
    P, q, mu, fz, c = _qps()
    return tpdip.solve_qp_pdip(P[i], q[i], mu, fz, contact=c[i], iters=iters)


def _jax_u(i, iters):
    P, q, _, _, c = _qps()
    return np.asarray(_jax_pdip(iters)(P[i].numpy(), q[i].numpy(),
                                       c[i].numpy()).u)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_pdip_matches_jax(i):
    res = _port_pdip(i, PDIP_ITERS)
    assert res.u.shape == (120,) and res.gap.shape == ()
    close(res.u, _jax_u(i, PDIP_ITERS), 1e-8, what="u [N]")
    assert float(res.gap) < 1e-8


def test_pdip_freezes_where_jax_does():
    """A Newton matrix that is not positive definite: JAX's Cholesky gives
    NaN, the port's (torch.linalg.cholesky_ex, info > 0) too, and the
    non-finite direction freezes the iterate in both, on the same
    iteration, before convergence."""
    frozen = _port_pdip(3, PDIP_ITERS)
    assert float(frozen.gap) > 1e-6
    k = next(k for k in range(PDIP_ITERS + 1)
             if torch.equal(_port_pdip(3, k).u, frozen.u))
    assert 1 < k < PDIP_ITERS
    assert not torch.equal(_port_pdip(3, k - 1).u, frozen.u)
    want = _jax_u(3, PDIP_ITERS)
    assert np.array_equal(_jax_u(3, k), want)
    assert not np.array_equal(_jax_u(3, k - 1), want)
    close(frozen.u, want, 1e-8, what="frozen u [N]")


def test_mpc_tick_serves_one_robot():
    final = _jax_single("kf0")[2]
    loop = loop_state_from_numpy(jax.tree.map(
        lambda x: np.repeat(np.asarray(x)[None], 2, 0), final))
    with pytest.raises(ValueError):
        tmpc.mpc_tick(loop.controller, tstep.broadcast_params(TP, 2),
                      tgait.trot_pattern(torch.float64, CPU), 0.01,
                      horizon=10)


# --- terrain in the batched tick ------------------------------------------

B2, H30, ITERS = 2, 30, 12
HEIGHTS = (0.29, 0.31)
TERRAIN_VELX = 0.15


@functools.lru_cache(maxsize=None)
def _jax_terrain():
    pattern = jgait.named_pattern("standing_trot", F64)
    pb = jstep.broadcast_params(JP, B2)
    cs = jstep.controller_init(JP, dtype=F64, body_height=0.3)
    loop = jstep.LoopState(
        controller=jax.tree.map(lambda x: jnp.stack([x] * B2), cs),
        sim=jax.vmap(lambda h: jsim.sim_init(
            JP, height=h, dtype=F64, terrain=PLATFORM))(
            jnp.asarray(HEIGHTS, F64)))
    init, rec, warm = np_tree(loop), [], None
    for k in range(STAND + WALK):
        if k >= STAND:
            cs = _walk(loop.controller, TERRAIN_VELX, jnp)
            g = jterr.height_at(PLATFORM, loop.sim.pos[:, :2])
            loop = loop.replace(controller=cs.replace(
                joy=cs.joy.replace(body_height=0.3 + g)))
        loop, warm = jstep.closed_loop_tick_batched(
            loop, pb, pattern, horizon=H30, iters=ITERS, solver="riccati",
            backend="xla", terrain=PLATFORM, warm=warm)
        rec.append(_record(loop))
    return init, rec


def test_terrain_tick_matches_jax():
    init, rec = _jax_terrain()
    terr = tterr.terrain_from_numpy(np_tree(PLATFORM))
    pattern = tgait.named_pattern("standing_trot", torch.float64, CPU)
    pb = tstep.broadcast_params(TP, B2)
    loop, warm = loop_state_from_numpy(init), None
    for k in range(STAND + WALK):
        if k >= STAND:
            cs = _walk(loop.controller, TERRAIN_VELX, torch)
            g = tterr.height_at(terr, loop.sim.pos[:, :2])
            loop = loop.replace(controller=cs.replace(
                joy=cs.joy.replace(body_height=0.3 + g)))
        # fused_substeps stays at its default: a height field takes the
        # per-substep loop whatever it says
        loop, warm = tstep.closed_loop_tick_batched(
            loop, pb, pattern, horizon=H30, iters=ITERS, solver="riccati",
            terrain=terr, warm=warm)
        pos, vel, grf = _record(loop)
        close(pos, rec[k][0], 1e-6, what=f"pos tick {k}")
        close(vel, rec[k][1], 1e-6, what=f"vel tick {k}")
        close(grf, rec[k][2], 1e-6, what=f"GRF tick {k}")
    assert warm.shape == (B2, 12 * H30)
    # the front feet stand on the platform's edge: the terrain is in play
    assert float(loop.sim.anchor[:, :2, 2].max()) > 0.005
