"""Checkpoint / resume for long batched sweeps
(`legged_mpc_control_tpu/utils/checkpoint.py`).

The reference persists nothing but rosbags (SURVEY.md §5 "Checkpoint /
resume: None"). Batched multi-hour domain-randomization sweeps need real
snapshots: the full scenario-batched loop state (controller + sim +
estimator + gait), a tree of `tree.Struct` dataclasses of tensors.

The file format is the port's own: a pickle of `tree.to_numpy(state)` (a
nested dict of numpy arrays, keyed by field name), the qualified names of
the tree's dataclasses and the step. The JAX package pickles a JAX treedef
instead, which cannot be read without JAX, so neither package reads the
other's files.
"""

import dataclasses
import importlib
import os
import pickle
from typing import Any

import torch

from legged_mpc_control_tpu_torch.tree import to_numpy


def _qualname(cls) -> str:
    return f"{cls.__module__}:{cls.__qualname__}"


def _classes(state):
    """The tree's skeleton: for a dataclass, its qualified name and each
    field's skeleton; for a dict of tensors, each key's; None for a
    tensor leaf."""
    if dataclasses.is_dataclass(state):
        return (_qualname(type(state)), {
            f.name: _classes(getattr(state, f.name))
            for f in dataclasses.fields(state)})
    if isinstance(state, dict):
        return ("dict", {k: _classes(v) for k, v in state.items()})
    return None


def _resolve(name: str):
    module, qual = name.split(":")
    cls = importlib.import_module(module)
    for part in qual.split("."):
        cls = getattr(cls, part)
    if not dataclasses.is_dataclass(cls):
        raise ValueError(f"checkpoint names {name}, not a dataclass")
    return cls


def _build(skeleton, arrays, like=None):
    """Rebuild a tree from its skeleton and arrays; each leaf a tensor on
    the CPU with the saved dtype, or with `like`'s dtype and device."""
    if skeleton is None:
        if like is None:
            return torch.as_tensor(arrays)
        return torch.as_tensor(arrays, dtype=like.dtype, device=like.device)
    name, fields = skeleton
    kw = {k: _build(sub, arrays[k],
                    None if like is None else
                    (like[k] if isinstance(like, dict) else getattr(like, k)))
          for k, sub in fields.items()}
    return kw if name == "dict" else _resolve(name)(**kw)


def _to_numpy(state):
    if isinstance(state, dict):
        return {k: _to_numpy(v) for k, v in state.items()}
    return to_numpy(state)


def save_checkpoint(path: str, state: Any, step: int = 0):
    """Snapshot a tree of tensor dataclasses (e.g. a batched LoopState)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        pickle.dump({"state": _to_numpy(state), "classes": _classes(state),
                     "step": step}, fh)


def load_checkpoint(path: str, target: Any = None):
    """Restore a tree. Without `target` each leaf is a CPU tensor of the
    saved dtype; with one, the structure (dataclass names and fields) is
    checked against it (ValueError on a mismatch) and each leaf takes the
    target leaf's dtype and device. Returns (state, step)."""
    with open(path, "rb") as fh:
        blob = pickle.load(fh)
    if target is not None and _classes(target) != blob["classes"]:
        raise ValueError(f"checkpoint structure mismatch: "
                         f"{blob['classes']} vs {_classes(target)}")
    return _build(blob["classes"], blob["state"], target), blob["step"]
