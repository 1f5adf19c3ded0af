"""Helpers of the PyTorch-port parity tests: carry JAX pytrees across as
numpy, and compare torch results with JAX ones."""

import dataclasses

import jax
import numpy as np
import torch


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
