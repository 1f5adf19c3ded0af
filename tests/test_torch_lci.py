"""PyTorch port vs the JAX package: the LCI-MPC seam (`mpc/lci_mpc.py`) and
the contact-implicit closed-loop tick (`control/step.py:
closed_loop_tick_lci_batched`), in f64 from the same JAX initial state.

The seam pieces (`pack_policy_state`, `make_stand_policy`,
`lci_mpc_tick_batched` with the batched CI walk policy) agree to 1e-10 in
the state and 1e-8 in the solve's forces. Three closed-loop ticks at B=3,
6 sweeps, agree to 1e-6, as the convex loop's in tests/test_torch_slice.py:
on flat ground the port's default dispatch (in float64 the "plain" backend,
since the fused kernel K7 needs float32) with the fused substep chain (the
plain version of K2) against JAX's unfused loop; on a boxed terrain both
unfused."""

import jax
import jax.numpy as jnp
import numpy as np
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
from torch_parity import close, np_tree, params_mapping

F64 = jnp.float64
JP = ja1(F64)
TP = params_from_numpy(params_mapping(JP))
B, ITERS, TICKS = 3, 6, 3
TERR = {"flat": jterr.flat(extent=3.0, cell=0.05, dtype=F64)}
TERR["boxed"] = jterr.add_box(TERR["flat"], center_xy=(0.5, 0.0),
                              size_xy=(0.5, 2.0), height=0.03)
WALK = {name: jci.make_ci_walk_policy_batched(JP, terrain=tr, velx=0.1,
                                              iters=ITERS)
        for name, tr in TERR.items()}
STAND = jlci.make_stand_policy(JP, body_height=0.3)


def _init():
    """The JAX batch of bench.py's CI cells: standing starts, walk mode."""
    loop = jrunner.init_loop_batch(JP, B, jax.random.PRNGKey(3), dtype=F64)
    cs = loop.controller
    cs = cs.replace(ctrl=cs.ctrl.replace(
        movement_mode=jnp.ones((B,), jnp.int32)))
    return loop.replace(controller=cs)


def _lci_init(name):
    """Walking from the start with the policy clock 3 ms past a tick: the
    trot template switches a leg where (t + k dt_plan) gait_freq crosses
    a half-integer, and a clock exactly on one (t = 0.02 s, stage 9) lets
    rounding pick the side (JAX's own jitted and eager calls then plan
    different forces)."""
    lci = jlci.lci_init_batched(B, dtype=F64,
                                policy_warm=WALK[name].warm_init(B, F64))
    return lci.replace(prev_mode=jnp.ones((B,), jnp.int32),
                       policy_time=jnp.full((B,), 0.003, F64))


@pytest.fixture(scope="module")
def jax_out():
    loop0 = _init()
    out = {"loop0": np_tree(loop0),
           "lci0": {n: np_tree(_lci_init(n)) for n in TERR}}
    for name in TERR:
        lci = _lci_init(name)
        tick = jax.jit(lambda lp, lc, tt, _n=name:
                       jstep.closed_loop_tick_lci_batched(
                           lp, lc, JP, STAND, WALK[_n], tt,
                           terrain=None if _n == "flat" else TERR[_n]))
        loop, states = loop0, []
        for k in range(TICKS):
            loop, lci = tick(loop, lci, jnp.asarray(0.01 * k, F64))
            states.append((np_tree(loop), np_tree(lci)))
        out[name] = states
    # the seam on the state after one flat tick, in one call
    loop1, lci1 = out["flat"][0]
    jl = jax.tree.map(jnp.asarray, loop1)
    jc = jax.tree.map(jnp.asarray, lci1)
    out["pack"] = np_tree(jax.vmap(jlci.pack_policy_state)(jl.controller.fbk,
                                                           jc))
    out["stand"] = np_tree(jax.vmap(STAND)(out["pack"][0],
                                           jnp.asarray([0.1, 0.2, 0.3])))
    seam = jax.jit(lambda cs, lc: jlci.lci_mpc_tick_batched(
        cs, lc, STAND, WALK["flat"], 0.0, 0.01))(jl.controller, jc)
    out["seam"] = np_tree(seam)
    return out


def _policies(name):
    tr = tterr.terrain_from_numpy(np_tree(TERR[name]))
    return tr, tci.make_ci_walk_policy_batched(TP, terrain=tr, velx=0.1,
                                               iters=ITERS)


def _lci0(walk):
    return tlci.lci_init_batched(
        B, torch.float64, walk.warm_init(B, torch.float64, "cpu"),
        device="cpu")


def test_pack_and_stand(jax_out):
    loop1, lci1 = jax_out["flat"][0]
    loop = loop_state_from_numpy(loop1)
    lci = tlci.lci_state_from_numpy(lci1)
    x, fp, fv = tlci.pack_policy_state(loop.controller.fbk, lci)
    for g, w in zip((x, fp, fv), jax_out["pack"]):
        close(g, w, 1e-12)
    stand = tlci.make_stand_policy(TP, body_height=0.3)
    close(stand(x, torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64)),
          jax_out["stand"], 1e-12)


def test_seam_tick(jax_out):
    loop1, lci1 = jax_out["flat"][0]
    cs = loop_state_from_numpy(loop1).controller
    _, walk = _policies("flat")
    stand = tlci.make_stand_policy(TP, body_height=0.3)
    got_cs, got_lci = tlci.lci_mpc_tick_batched(
        cs, tlci.lci_state_from_numpy(lci1), stand, walk, 0.0, 0.01)
    want_cs, want_lci = jax_out["seam"]
    close(got_cs.ctrl.optimized_state, want_cs.ctrl.optimized_state, 1e-10)
    close(got_cs.ctrl.optimized_input, want_cs.ctrl.optimized_input, 1e-8,
          what="GRF [N]")
    close(got_cs.ctrl.plan_contacts, want_cs.ctrl.plan_contacts, 0.0)
    assert bool(got_cs.mpc_inited.all())
    got_np = tlci.lci_state_to_numpy(got_lci)
    for f in ("prev_foot_pos", "prev_foot_vel", "policy_time"):
        close(got_np[f], getattr(want_lci, f), 1e-12, what=f)
    assert np.array_equal(got_np["prev_mode"], want_lci.prev_mode)
    close(got_np["policy_warm"]["u"], want_lci.policy_warm["u"], 1e-8)
    # a single-robot stateful engine cannot serve the batch
    with pytest.raises(TypeError, match="batched"):
        tlci.lci_mpc_tick_batched(cs, _lci0(walk), stand,
                                  tci.make_ci_walk_policy(TP), 0.0, 0.01)


@pytest.mark.parametrize("name", ["flat", "boxed"])
def test_closed_loop_ticks_match_jax(jax_out, name):
    tr, walk = _policies(name)
    stand = tlci.make_stand_policy(TP, body_height=0.3)
    loop = loop_state_from_numpy(jax_out["loop0"])
    lci = tlci.lci_state_from_numpy(jax_out["lci0"][name])
    cuda_build.LAUNCHES.clear()
    for k in range(TICKS):
        loop, lci = tstep.closed_loop_tick_lci_batched(
            loop, lci, TP, stand, walk, 0.01 * k,
            terrain=None if name == "flat" else tr)
        want, want_lci = jax_out[name][k]
        for f in ("pos", "vel", "quat", "omega", "q"):
            close(getattr(loop.sim, f), getattr(want.sim, f), 1e-6,
                  what=f"{f} tick {k}")
        assert np.array_equal(loop.sim.contact.numpy(), want.sim.contact)
        close(loop.controller.ctrl.optimized_input,
              want.controller.ctrl.optimized_input, 1e-6,
              what=f"optimized_input tick {k}")
        close(lci.policy_warm["u"], want_lci.policy_warm["u"], 1e-6)
    assert sum(cuda_build.LAUNCHES.values()) == 0
    assert bool((lci.policy_warm["valid"] == 1).all())


def test_solo_policy_is_the_batched_view(jax_out):
    """`make_ci_walk_policy` is the B=1 view of the batched policy."""
    loop1, lci1 = jax_out["flat"][0]
    lci = tlci.lci_state_from_numpy(lci1)
    x, _, _ = tlci.pack_policy_state(
        loop_state_from_numpy(loop1).controller.fbk, lci)
    tr, walk = _policies("flat")
    solo = tci.make_ci_walk_policy(TP, terrain=tr, velx=0.1, iters=ITERS)
    tt = torch.full((B,), 0.05, dtype=torch.float64)
    out_b, warm_b = walk(x, tt, lci.policy_warm)
    out_s, warm_s = solo(x[1], tt[1], {k: v[1] for k, v in
                                       lci.policy_warm.items()})
    close(out_s, out_b[1], 1e-12)
    close(warm_s["u"], warm_b["u"][1], 1e-12)
    w0 = solo.warm_init(torch.float64, "cpu")
    assert w0["u"].shape == (10, 24) and w0["valid"].shape == ()
