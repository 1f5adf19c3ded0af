"""Dataclass containers of tensors: the PyTorch stand-in for flax structs.

Every state container of the package is a `Struct` dataclass whose leaves are
tensors (or nested `Struct`s). `tree_map` applies a function to every tensor
leaf, which is what `jax.tree.map` did for the JAX package.
"""

import dataclasses


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
