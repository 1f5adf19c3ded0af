"""PyTorch port vs the JAX package: the batched contact-implicit closed-loop
tick (`control/step.py: closed_loop_tick_lci_batched`) on estimated state,
in f64 from the same JAX initial state: kf_type 1 (the linear KF) and 2
(the EKF) on flat ground, three ticks each, and one kf_type-1 tick on a
boxed height field; and `seed_batched_feedback(terrain=)`.

The recipe is tests/test_torch_lci.py's: A1, B=3, 6 sweeps, walking from
the start with the policy clock 3 ms past a tick (ROADMAP fault 7). Both
ticks take the per-substep loop here (JAX's runs the KF unfused; the
port's never takes K3's in-chain filter in this tick). Every leaf of the
loop state (the simulator, the Feedback, the targets, the gait, both
filters' state and covariance) and the policy's warm slot agree to 1e-6,
as in tests/test_torch_lci.py."""

import jax
import jax.numpy as jnp
import pytest
import torch

from legged_mpc_control_tpu.config import a1_params as ja1
from legged_mpc_control_tpu.control import step as jstep
from legged_mpc_control_tpu.mpc import ci_mpc as jci
from legged_mpc_control_tpu.mpc import lci_mpc as jlci
from legged_mpc_control_tpu.parallel import runner as jrunner
from legged_mpc_control_tpu.sim import terrain as jterr
from legged_mpc_control_tpu_torch.config import params_from_numpy
from legged_mpc_control_tpu_torch.control import step as tstep
from legged_mpc_control_tpu_torch.mpc import ci_mpc as tci
from legged_mpc_control_tpu_torch.mpc import lci_mpc as tlci
from legged_mpc_control_tpu_torch.ops import cuda_build
from legged_mpc_control_tpu_torch.sim import terrain as tterr
from legged_mpc_control_tpu_torch.types import loop_state_from_numpy
from torch_parity import close, close_tree, np_tree, params_mapping

F64 = jnp.float64
JP = ja1(F64)
TP = params_from_numpy(params_mapping(JP))
B, ITERS, TICKS = 3, 6, 3
TOL = 1e-6
TERR = {"flat": jterr.flat(extent=3.0, cell=0.05, dtype=F64)}
TERR["boxed"] = jterr.add_box(TERR["flat"], center_xy=(0.5, 0.0),
                              size_xy=(0.5, 2.0), height=0.03)
# under the front feet of a batch standing at the origin
SEED_BOX = jterr.add_box(TERR["flat"], center_xy=(0.25, 0.0),
                         size_xy=(0.3, 2.0), height=0.03)
# case -> (terrain, tick keywords, ticks)
CASES = {"kf1": ("flat", dict(kf_type=1), TICKS),
         "kf2": ("flat", dict(kf_type=2), TICKS),
         "kf1_boxed": ("boxed", dict(kf_type=1), 1)}
WALK = {name: jci.make_ci_walk_policy_batched(JP, terrain=tr, velx=0.1,
                                              iters=ITERS)
        for name, tr in TERR.items()}
STAND = jlci.make_stand_policy(JP, body_height=0.3)


def _init():
    """The JAX batch of bench.py's CI cells: standing starts, walk mode."""
    loop = jrunner.init_loop_batch(JP, B, jax.random.PRNGKey(5), dtype=F64)
    cs = loop.controller
    cs = cs.replace(ctrl=cs.ctrl.replace(
        movement_mode=jnp.ones((B,), jnp.int32)))
    return loop.replace(controller=cs)


def _lci_init(terr):
    lci = jlci.lci_init_batched(B, dtype=F64,
                                policy_warm=WALK[terr].warm_init(B, F64))
    return lci.replace(prev_mode=jnp.ones((B,), jnp.int32),
                       policy_time=jnp.full((B,), 0.003, F64))


def _jterrain(terr):
    return None if terr == "flat" else TERR[terr]


@pytest.fixture(scope="module")
def jax_out():
    loop0 = _init()
    out = {"loop0": np_tree(loop0)}
    for case, (terr, kw, ticks) in CASES.items():
        lci = _lci_init(terr)
        out["lci0", case] = np_tree(lci)
        tick = jax.jit(lambda lp, lc, tt, _t=terr, _kw=kw:
                       jstep.closed_loop_tick_lci_batched(
                           lp, lc, JP, STAND, WALK[_t], tt,
                           terrain=_jterrain(_t), **_kw))
        loop, states = loop0, []
        for k in range(ticks):
            loop, lci = tick(loop, lci, jnp.asarray(0.01 * k, F64))
            states.append((np_tree(loop), np_tree(lci)))
        out[case] = states
    # the seeding pass with a box under the front feet, kf_type 1, from
    # the state after one kf1 tick (a started filter)
    pb = jstep.broadcast_params(JP, B)
    seeded = jax.jit(lambda lp: jstep.seed_batched_feedback(
        lp, pb, kf_type=1, terrain=SEED_BOX))(
            jax.tree.map(jnp.asarray, out["kf1"][0][0]))
    out["seeded"] = np_tree(seeded)
    return out


def _walk(terr):
    tr = tterr.terrain_from_numpy(np_tree(TERR[terr]))
    return tr, tci.make_ci_walk_policy_batched(TP, terrain=tr, velx=0.1,
                                               iters=ITERS)


@pytest.mark.parametrize("case", list(CASES))
def test_estimated_ticks_match_jax(jax_out, case):
    terr, kw, ticks = CASES[case]
    tr, walk = _walk(terr)
    stand = tlci.make_stand_policy(TP, body_height=0.3)
    loop = loop_state_from_numpy(jax_out["loop0"])
    lci = tlci.lci_state_from_numpy(jax_out["lci0", case])
    cuda_build.LAUNCHES.clear()
    for k in range(ticks):
        loop, lci = tstep.closed_loop_tick_lci_batched(
            loop, lci, TP, stand, walk, 0.01 * k,
            terrain=None if terr == "flat" else tr, **kw)
        want, want_lci = jax_out[case][k]
        close_tree(loop, want, TOL, what=f"{case} tick {k}")
        for f in ("prev_foot_pos", "prev_foot_vel", "policy_time"):
            close(getattr(lci, f), getattr(want_lci, f), TOL, what=f)
        close(lci.policy_warm["u"], want_lci.policy_warm["u"], TOL)
    assert sum(cuda_build.LAUNCHES.values()) == 0
    cs = loop.controller
    # the filter ran: its estimate is the Feedback's root state
    filt = cs.ekf if kw["kf_type"] == 2 else cs.kf
    assert bool(filt.initialized.all())
    close(cs.fbk.root_pos, filt.x[:, 0:3].numpy(), 0.0)
    assert float((filt.x[:, 0:3] - loop.sim.pos).abs().max()) < 0.02


def test_seed_batched_feedback_terrain(jax_out):
    loop1 = loop_state_from_numpy(jax_out["kf1"][0][0])
    box = tterr.terrain_from_numpy(np_tree(SEED_BOX))
    pb = tstep.broadcast_params(TP, B)
    got = tstep.seed_batched_feedback(loop1, pb, kf_type=1, terrain=box)
    close_tree(got, jax_out["seeded"], 1e-10, what="seeded")
    # the footholds read the box: they differ from the flat ground's
    flat = tstep.seed_batched_feedback(loop1, pb, kf_type=1)
    assert not torch.equal(got.controller.ctrl.foot_pos_target_world,
                           flat.controller.ctrl.foot_pos_target_world)
