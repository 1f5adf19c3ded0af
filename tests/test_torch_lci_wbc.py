"""PyTorch port vs the JAX package: the batched contact-implicit closed-loop
tick (`control/step.py: closed_loop_tick_lci_batched`) with the WBC
(low_level_type 1) and, at kf_type 0, with `fused_substeps=False`, in f64
from the same JAX initial state, three ticks each on flat ground.

The recipe is tests/test_torch_lci.py's: A1, B=3, 6 sweeps, walking from
the start with the policy clock 3 ms past a tick (ROADMAP fault 7). Both
cases take the per-substep loop in both packages (the WBC against A1's
whole-body model, its hierarchy in float64 in both, fault 11). Every leaf
of the loop state and the policy's warm slot agree to 1e-6, as in
tests/test_torch_lci.py. (A file of its own beside
tests/test_torch_lci_estimated.py, for the time JAX takes to compile the
WBC tick.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu.config import a1_params as ja1
from legged_mpc_control_tpu.control import hoqp as jhoqp
from legged_mpc_control_tpu.control import step as jstep
from legged_mpc_control_tpu.mpc import ci_mpc as jci
from legged_mpc_control_tpu.mpc import lci_mpc as jlci
from legged_mpc_control_tpu.parallel import runner as jrunner
from legged_mpc_control_tpu.sim import terrain as jterr
from legged_mpc_control_tpu_torch.config import params_from_numpy
from legged_mpc_control_tpu_torch.control import hoqp as thoqp
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
FLAT = jterr.flat(extent=3.0, cell=0.05, dtype=F64)
# the WBC case runs 2 substeps a tick: JAX unrolls the substeps, and its 8
# WBC substeps take ~80 s to trace and compile on one CPU core; the port
# runs the same loop for any count
CASES = {"wbc": dict(low_level_type=1, substeps=2),
         "unfused": dict(fused_substeps=False)}
WALK = jci.make_ci_walk_policy_batched(JP, terrain=FLAT, velx=0.1,
                                       iters=ITERS)
STAND = jlci.make_stand_policy(JP, body_height=0.3)


def _init():
    loop = jrunner.init_loop_batch(JP, B, jax.random.PRNGKey(6), dtype=F64)
    cs = loop.controller
    cs = cs.replace(ctrl=cs.ctrl.replace(
        movement_mode=jnp.ones((B,), jnp.int32)))
    lci = jlci.lci_init_batched(B, dtype=F64,
                                policy_warm=WALK.warm_init(B, F64))
    lci = lci.replace(prev_mode=jnp.ones((B,), jnp.int32),
                      policy_time=jnp.full((B,), 0.003, F64))
    return loop.replace(controller=cs), lci


@pytest.fixture(scope="module")
def jax_out():
    loop0, lci0 = _init()
    out = {"loop0": np_tree(loop0), "lci0": np_tree(lci0)}
    for case, kw in CASES.items():
        tick = jax.jit(lambda lp, lc, tt, _kw=kw:
                       jstep.closed_loop_tick_lci_batched(
                           lp, lc, JP, STAND, WALK, tt, **_kw))
        loop, lci, states = loop0, lci0, []
        for k in range(TICKS):
            loop, lci = tick(loop, lci, jnp.asarray(0.01 * k, F64))
            states.append((np_tree(loop), np_tree(lci)))
        out[case] = states
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_ticks_match_jax(jax_out, case):
    walk = tci.make_ci_walk_policy_batched(
        TP, terrain=tterr.terrain_from_numpy(np_tree(FLAT)), velx=0.1,
        iters=ITERS)
    stand = tlci.make_stand_policy(TP, body_height=0.3)
    loop = loop_state_from_numpy(jax_out["loop0"])
    lci = tlci.lci_state_from_numpy(jax_out["lci0"])
    cuda_build.LAUNCHES.clear()
    for k in range(TICKS):
        loop, lci = tstep.closed_loop_tick_lci_batched(
            loop, lci, TP, stand, walk, 0.01 * k, **CASES[case])
        want, want_lci = jax_out[case][k]
        close_tree(loop, want, TOL, what=f"{case} tick {k}")
        for f in ("prev_foot_pos", "prev_foot_vel", "policy_time"):
            close(getattr(lci, f), getattr(want_lci, f), TOL, what=f)
        close(lci.policy_warm["u"], want_lci.policy_warm["u"], TOL)
    assert sum(cuda_build.LAUNCHES.values()) == 0
    assert bool(lci.policy_warm["valid"].all())


def test_a_non_finite_scenario_leaves_the_others():
    """A scenario whose WBC hierarchy meets a non-finite matrix gets a NaN
    null basis, as JAX's SVD gives it, and the batch's other scenarios the
    bases JAX's give them (torch's SVD would refuse the whole batch; a
    fallen scenario in the walking-from-start WBC loop met it)."""
    A = np.random.default_rng(0).normal(size=(3, 6, 18))
    A[:, :, 12:] = 0.0                 # a rank-deficient block: a null space
    A[1, 2, 3] = np.nan
    want = np.asarray(jax.vmap(jhoqp.soft_nullspace)(A))
    got = thoqp.soft_nullspace(torch.as_tensor(A)).numpy()
    assert np.isnan(got[1]).all() and np.isnan(want[1]).all()
    for i in (0, 2):
        # the bases may differ by a rotation within the null space: compare
        # the projectors onto it
        close(got[i] @ got[i].T, want[i] @ want[i].T, 1e-10)
