"""The port's scale-out (`parallel/mesh.py`, `parallel/distributed.py`,
`utils/checkpoint.py`, the rollout's `stand_ticks_arg`) against the JAX
package and against itself, float64 on the CPU, one process.

  * JAX parity: JAX's `device_sharded_loop` on the suite's 8 virtual CPU
    devices (A1, 16 scenarios) carried across, then JAX's `make_sweep` and
    the port's with tests/test_distributed.py's settings (horizon 5, 3
    ticks, PDIP 8, velx 0), and once walking at 0.25 m/s with the stand
    phase ending after the first tick (`stand_ticks_now`): final states
    within 1e-9, the five metrics within 1e-12.
  * The rollout's `stand_ticks_arg` (and the twin's rollout's) equals a
    rollout built with that stand count, bit for bit, on either side of
    the stand-to-walk boundary.
  * Shard seeding: one process with 8 shards holds the rows of two
    processes with 4 shards each, bit for bit; the mesh's row helpers.
  * Resume: two reps of 3 ticks equal 3 ticks, `save_sharded`,
    `load_sharded` and 3 more, bit for bit.
  * Checkpoints: a round trip is exact, a load casts to the target's
    dtype, and a structure mismatch is refused (tests/test_utils.py:42-63).

Every JAX function is compiled once (XLA:CPU's compile count,
pytest.ini)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu.config import a1_params as ja1
from legged_mpc_control_tpu.mpc import gait as jgait
from legged_mpc_control_tpu.parallel import distributed as jdist
from legged_mpc_control_tpu_torch.config import params_from_numpy
from legged_mpc_control_tpu_torch.control import step as tstep
from legged_mpc_control_tpu_torch.models import whole_body as twb
from legged_mpc_control_tpu_torch.mpc import gait as tgait
from legged_mpc_control_tpu_torch.parallel import distributed as tdist
from legged_mpc_control_tpu_torch.parallel import mesh as tmesh
from legged_mpc_control_tpu_torch.parallel import runner as trunner
from legged_mpc_control_tpu_torch.sim import srb_sim
from legged_mpc_control_tpu_torch.tree import to_numpy, tree_map
from legged_mpc_control_tpu_torch.types import loop_state_from_numpy
from legged_mpc_control_tpu_torch.utils import checkpoint as tckpt
from torch_parity import close_tree, np_tree, params_mapping

F64 = jnp.float64
CPU = torch.device("cpu")
JP = ja1(F64)
TP = params_from_numpy(params_mapping(JP))
TPAT = tgait.trot_pattern(torch.float64, CPU)
# tests/test_distributed.py:58-61, and the walk that crosses its stand
# phase after the first tick
SWEEPS = {"stand": dict(walk_velx=0.0, stand_now=None),
          "walk": dict(walk_velx=0.25, stand_now=1)}
KW = dict(horizon=5, n_ticks=3, pdip_iters=8)
STATE_TOL = 1e-9
METRIC_TOL = 1e-12


def _mesh(world=1, rank=0, shards=8):
    return tmesh.ScenarioMesh(world, rank, shards, CPU)


@functools.lru_cache(maxsize=None)
def _jax_start():
    mesh = jdist.global_mesh()
    loop = jdist.device_sharded_loop(JP, 16, jax.random.PRNGKey(0), mesh,
                                     dtype=F64)
    return mesh, loop


@functools.lru_cache(maxsize=None)
def _jax_sweep(name):
    """JAX's global sweep over the recipe `name`: (start, final, metrics),
    the states as numpy trees."""
    mesh, loop = _jax_start()
    s = SWEEPS[name]
    sweep = jdist.make_sweep(jgait.trot_pattern(F64), mesh,
                             walk_velx=s["walk_velx"], **KW)
    final, metrics = sweep(loop, jdist.replicate_global(mesh, JP),
                           stand_ticks_now=s["stand_now"])
    return np_tree(loop), np_tree(final), metrics


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_matches_jax(name):
    start, jfinal, jmetrics = _jax_sweep(name)
    s = SWEEPS[name]
    sweep = tdist.make_sweep(TPAT, _mesh(), walk_velx=s["walk_velx"], **KW)
    final, metrics = sweep(loop_state_from_numpy(start), TP,
                           stand_ticks_now=s["stand_now"])
    close_tree(final, jfinal, STATE_TOL, "final")
    assert metrics.keys() == jmetrics.keys()
    for k, v in metrics.items():
        assert abs(v - jmetrics[k]) <= METRIC_TOL, (k, v, jmetrics[k])
    assert metrics["upright_frac"] == 1.0
    # the walk starts after the first tick: the batch moves forward
    walking = s["walk_velx"] != 0.0
    assert (metrics["mean_speed"] > 0.02) == walking, metrics
    assert (abs(metrics["mean_speed"]) < 1e-6) != walking, metrics


def _start(batch=8, seed=5):
    return tdist.device_sharded_loop(TP, batch, seed, _mesh(shards=2),
                                     dtype=torch.float64)


def _equal(a, b):
    """Bitwise equality of two trees; returns the number of leaves."""
    n = []

    def eq(x, y):
        assert x.dtype == y.dtype and torch.equal(x, y)
        n.append(1)
        return x
    tree_map(eq, a, b)
    return len(n)


@pytest.mark.parametrize("stand", [0, 2, 4])
def test_rollout_stand_ticks_arg(stand):
    """A call's stand_ticks_arg is the build-time stand_ticks: 2 crosses
    into the walk inside the 4 ticks, 0 walks throughout, 4 stands."""
    loop = _start()
    kw = dict(horizon=5, n_ticks=4, pdip_iters=6, walk_velx=0.25)
    built = trunner.make_batched_rollout(TPAT, stand_ticks=stand, **kw)
    other = trunner.make_batched_rollout(TPAT, stand_ticks=7, **kw)
    want, (wpos, _) = built(loop, TP)
    got, (gpos, _) = other(loop, TP, stand)
    assert _equal(got, want) > 50 and torch.equal(gpos, wpos)
    modes = got.controller.ctrl.movement_mode
    assert bool((modes == int(stand < 4)).all())


def test_rollout_wb_stand_ticks_arg():
    """The twin's rollout takes the same override: its stand phase ends
    after the first of 2 ticks whatever it was built with."""
    model = twb.a1_wb_model(torch.float64, CPU)
    loop = trunner.init_wb_loop_batch(TP, model, 2,
                                      torch.Generator().manual_seed(4),
                                      dtype=torch.float64, device=CPU)
    kw = dict(horizon=5, n_ticks=2, pdip_iters=4, walk_velx=0.2)
    want = trunner.make_batched_rollout_wb(TPAT, model, stand_ticks=1,
                                           **kw)(loop, TP)[0]
    got = trunner.make_batched_rollout_wb(TPAT, model, stand_ticks=20,
                                          **kw)(loop, TP, 1)[0]
    assert _equal(got, want) > 50
    assert bool((got.controller.ctrl.movement_mode == 1).all())


def test_shard_seeding_is_layout_free():
    one = tdist.device_sharded_loop(TP, 16, 3, _mesh(1, 0, 8),
                                    dtype=torch.float64)
    two = [tdist.device_sharded_loop(TP, 16, 3, _mesh(2, r, 4),
                                     dtype=torch.float64) for r in (0, 1)]
    assert _equal(one, tree_map(lambda *x: torch.cat(x), *two)) > 50
    # each shard is its own draw: the 8 shards' heights are not repeats
    z = one.sim.pos[:, 2].reshape(8, 2)
    assert len({tuple(r.tolist()) for r in z}) == 8
    for r in (0, 1):
        m = _mesh(2, r, 4)
        assert _equal(tmesh.shard_scenarios(m, one), two[r]) > 50
        assert m.local_rows(16) == slice(8 * r, 8 * r + 8)
        assert list(m.shard_ids()) == list(range(4 * r, 4 * r + 4))
    with pytest.raises(ValueError):
        tdist.device_sharded_loop(TP, 12, 3, _mesh(1, 0, 8))


def test_mesh_replicate_and_shard_mixed():
    p = trunner.randomize_params(TP, torch.Generator().manual_seed(1), 16)
    m = _mesh(2, 1, 4)
    mixed = tmesh.shard_mixed(m, p, 16)
    for f in dataclasses.fields(p):
        x, y = getattr(p, f.name), getattr(mixed, f.name)
        want = x[8:16] if x.dim() and x.shape[0] == 16 else x
        assert torch.equal(y, want), f.name
    assert mixed.mass.shape == (8,) and mixed.rho_fix.shape == (4, 5)
    assert _equal(tmesh.replicate(m, TP), TP) > 10


def test_resume_equals_uninterrupted(tmp_path):
    """sweep.py's rep and resume bookkeeping on the library: the stand
    phase (4 ticks) is consumed once across two reps of 3 ticks, and across
    a checkpoint between them."""
    mesh, stand, ticks = _mesh(shards=2), 4, 3
    sweep = tdist.make_sweep(TPAT, mesh, horizon=5, n_ticks=ticks,
                             pdip_iters=6, walk_velx=0.25, stand_ticks=stand)
    loop = _start()
    a, _ = sweep(loop, TP, stand_ticks_now=stand)
    want, wm = sweep(a, TP, stand_ticks_now=max(0, stand - ticks))
    path = str(tmp_path / "ck")
    tdist.save_sharded(path, a, step=ticks, mesh=mesh)
    back, step = tdist.load_sharded(path, mesh)
    assert step == ticks and _equal(back, a) > 50
    got, gm = sweep(back, TP, stand_ticks_now=max(0, stand - step))
    assert _equal(got, want) > 50 and gm == wm
    assert bool((got.controller.ctrl.movement_mode == 1).all())
    assert tdist.load_sharded(path, mesh, step_only=True) == (None, ticks)


def test_checkpoint_round_trip(tmp_path):
    loop = _start(4)
    path = str(tmp_path / "ckpt.pkl")
    tckpt.save_checkpoint(path, loop, step=42)
    restored, step = tckpt.load_checkpoint(path, target=loop)
    assert step == 42 and _equal(restored, loop) > 50
    plain, _ = tckpt.load_checkpoint(path)
    assert type(plain) is type(loop) and _equal(plain, loop) > 50
    f32 = tree_map(lambda x: x.float() if x.is_floating_point() else x, loop)
    cast, _ = tckpt.load_checkpoint(path, target=f32)
    assert cast.sim.pos.dtype == torch.float32
    assert cast.sim.contact.dtype == torch.bool
    np.testing.assert_array_equal(cast.sim.pos.numpy(),
                                  loop.sim.pos.float().numpy())
    d = {"a": torch.zeros(3), "b": torch.arange(4)}
    tckpt.save_checkpoint(path, d)
    back, _ = tckpt.load_checkpoint(path, target=d)
    assert torch.equal(back["a"], d["a"]) and torch.equal(back["b"], d["b"])


def test_checkpoint_structure_mismatch_rejected(tmp_path):
    loop = _start(4)
    path = str(tmp_path / "ckpt.pkl")
    tckpt.save_checkpoint(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(path, target=loop)
    tckpt.save_checkpoint(path, srb_sim.sim_init(TP, [0.3],
                                                 torch.float64, CPU))
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(path, target=loop)
    tckpt.save_checkpoint(path, tstep.controller_init(TP, 4, torch.float64,
                                                      CPU))
    with pytest.raises(ValueError):
        tckpt.load_checkpoint(path, target=loop.controller.replace(
            kf=loop.sim))
    assert to_numpy(loop.sim)["pos"].shape == (4, 3)
