"""Helpers of the PyTorch-port parity tests: carry JAX pytrees across as
numpy, and compare torch results with JAX ones.

Importing it pins PyTorch to one intra-op thread: the tests' tensors hold a
handful of scenarios, where the thread pool costs far more than it saves
(and the suite's xdist workers would each start one)."""

import dataclasses

import jax
import numpy as np
import torch

torch.set_num_threads(1)


def np_tree(tree):
    """A JAX pytree with numpy leaves (what the port's converters take)."""
    return jax.tree.map(np.asarray, tree)


def t(x):
    """numpy / JAX array -> torch tensor, dtype kept."""
    return torch.as_tensor(np.array(x))


def params_mapping(jparams):
    """Field name -> numpy array of a JAX RobotParams."""
    return {f.name: np.asarray(getattr(jparams, f.name))
            for f in dataclasses.fields(jparams)}


def jax_tree_from(template, tree):
    """A JAX pytree shaped like `template` (flax dataclasses) with its
    leaves taken by field name from `tree`, nested dicts of arrays (the
    port's `loop_state_to_numpy`): carries a state the port built into
    the JAX package."""
    if dataclasses.is_dataclass(template):
        return template.replace(**{
            f.name: jax_tree_from(getattr(template, f.name), tree[f.name])
            for f in dataclasses.fields(template)})
    return jax.numpy.asarray(tree)


def close(got, want, atol, rtol=0.0, what=""):
    if torch.is_tensor(got):
        got = got.detach().cpu().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


def close_tree(got, want, atol, what=""):
    """Compare a port dataclass tree with a JAX pytree, field by field."""
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            close_tree(getattr(got, f.name), getattr(want, f.name), atol,
                       f"{what}.{f.name}")
        return
    g = got.detach().cpu().numpy()
    w = np.asarray(want)
    if g.dtype == bool or np.issubdtype(g.dtype, np.integer):
        assert np.array_equal(g, w), what
    else:
        close(g, w, atol, what=what)
