"""The port's whole-body models against the JAX package's, float64 on the
CPU, for A1 and Go1 at seeded configurations and velocities:

- `models/whole_body.py` (autodiff through `torch.func`): M, nle, the foot
  Jacobians, Jdot v, the feet and the CoM against JAX `whole_body`;
- `models/whole_body_b.py` (analytic CRBA/RNEA): `dyn_terms_b` and its
  accessors against JAX `whole_body_b`;
- the model converter: the JAX model's arrays give the port's model bit
  for bit, and back.

Tolerance 1e-10: the same float64 arithmetic in another order (M's entries
are O(0.01-10), nle's O(1-100)). The JAX terms are compiled once, for
both robots (XLA:CPU's compile count, pytest.ini)."""

import functools

import jax
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu.models import whole_body as jwb
from legged_mpc_control_tpu.models import whole_body_b as jwbb
from legged_mpc_control_tpu_torch.models import whole_body as twb
from legged_mpc_control_tpu_torch.models import whole_body_b as twbb
from legged_mpc_control_tpu_torch.tree import to_numpy
from torch_parity import close, t

B = 4
ATOL = 1e-10
ROBOTS = ("a1", "go1")


def _state(seed):
    """Seeded (q, v) around the standing pose, as tests/test_whole_body.py
    draws them."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, 18))
    q[:, 0:3] = rng.normal(scale=0.2, size=(B, 3))
    q[:, 3:6] = rng.normal(scale=0.3, size=(B, 3))
    q[:, 6:18] = np.tile([0.0, 0.8, -1.6], 4) + rng.normal(scale=0.5,
                                                          size=(B, 12))
    return q, rng.normal(scale=0.7, size=(B, 18))


Q, V = _state(3)


@jax.jit
def _jax_terms(q, v, m):
    """Both JAX models' terms; the model is an argument, so A1 and Go1
    share one compilation."""
    one = jax.vmap(lambda a, b: (
        jwb.mass_matrix(a, m), jwb.nonlinear_effects(a, b, m),
        jwb.foot_jacobians(a, m), jwb.foot_jdot_v(a, b, m),
        jwb.foot_positions(a, m), jwb.com_position(a, m)))
    return one(q, v), jwbb.dyn_terms_b(q, v, m)


@functools.lru_cache(maxsize=None)
def _jax(robot):
    m = jwb.wb_model_for(robot)
    autodiff, analytic = _jax_terms(Q, V, jax.tree.map(np.asarray, m))
    return m, [np.asarray(x) for x in autodiff], [np.asarray(x)
                                                   for x in analytic]


def _model(robot):
    return twb.wb_model_for(robot, torch.float64, "cpu")


@pytest.mark.parametrize("robot", ROBOTS)
def test_autodiff_model_matches_jax(robot):
    _, want, _ = _jax(robot)
    m, q, v = _model(robot), t(Q), t(V)
    got = (twb.mass_matrix(q, m), twb.nonlinear_effects(q, v, m),
           twb.foot_jacobians(q, m), twb.foot_jdot_v(q, v, m),
           twb.foot_positions(q, m), twb.com_position(q, m))
    for name, g, w in zip(("M", "nle", "J", "Jdot v", "feet", "CoM"), got,
                          want):
        assert g.shape == w.shape, name
        close(g, w, ATOL, what=f"{robot} {name}")
    # M is symmetric positive definite
    close(got[0], got[0].transpose(-1, -2), 1e-12)
    assert float(torch.linalg.eigvalsh(got[0]).min()) > 0.0


@pytest.mark.parametrize("robot", ROBOTS)
def test_analytic_model_matches_jax(robot):
    _, _, want = _jax(robot)
    m, q, v = _model(robot), t(Q), t(V)
    got = twbb.dyn_terms_b(q, v, m)
    for name, g, w in zip(("M", "nle", "J", "feet"), got, want):
        close(g, w, ATOL, what=f"{robot} {name}")
    close(twbb.mass_matrix_b(q, m), want[0], ATOL)
    close(twbb.foot_jacobians_b(q, m), want[2], ATOL)
    close(twbb.foot_positions_b(q, m), want[3], ATOL)
    # nle at zero velocity is the gravity vector alone
    g_only = twbb.nonlinear_effects_b(q, torch.zeros_like(v), m)
    close(g_only, twb.nonlinear_effects(q, torch.zeros_like(v), m), ATOL)


@pytest.mark.parametrize("robot", ROBOTS)
def test_model_converter_round_trips(robot):
    jm = _jax(robot)[0]
    m = twb.wb_model_from_numpy(jm)
    built = _model(robot)
    for name in vars(built):
        assert torch.equal(getattr(m, name), getattr(built, name)), name
        assert np.array_equal(to_numpy(m)[name], np.asarray(getattr(jm,
                                                                   name)))
    back = twb.wb_model_from_numpy(to_numpy(built), dtype=torch.float32)
    assert back.link_inertia.dtype == torch.float32
    assert torch.equal(back.hip_origin, built.hip_origin.float())
    assert torch.equal(twb.wb_model_for(robot, torch.float32,
                                        "cpu").link_com,
                       built.link_com.float())
    with pytest.raises(ValueError, match="unknown robot"):
        twb.wb_model_for("b1", device="cpu")
