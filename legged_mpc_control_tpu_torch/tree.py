"""Dataclass containers of tensors: the PyTorch stand-in for flax structs.

Every state container of the package is a `Struct` dataclass whose leaves are
tensors (or nested `Struct`s). `tree_map` applies a function to every tensor
leaf, which is what `jax.tree.map` did for the JAX package; `from_numpy` and
`to_numpy` carry a tree across from (and back to) numpy, keyed by field name,
so a JAX pytree converted with `np.asarray` enters the port unchanged.
"""

import dataclasses

import numpy as np
import torch


class Struct:
    """Mixin for tensor dataclasses: `replace` as on a flax struct."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def tree_map(fn, tree, *rest):
    """Apply `fn` leafwise over one or more trees of the same structure."""
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def _field(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def from_numpy(cls, tree, device=None):
    """Build a `cls` dataclass from `tree`: a dict or attribute object whose
    fields (recursively) hold array-likes. dtypes are kept as they are."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = _field(tree, f.name)
        if isinstance(f.type, type) and dataclasses.is_dataclass(f.type):
            kw[f.name] = from_numpy(f.type, v, device)
        else:
            kw[f.name] = torch.as_tensor(np.array(v), device=device)
    return cls(**kw)


def to_numpy(tree):
    """Nested dict of numpy arrays, the inverse of `from_numpy`."""
    if dataclasses.is_dataclass(tree):
        return {f.name: to_numpy(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    return tree.detach().cpu().numpy()
