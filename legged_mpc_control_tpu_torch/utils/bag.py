"""Structured diagnostics "bags" — the rosbag/LeggedLogger replacement
(`legged_mpc_control_tpu/utils/bag.py`).

The reference publishes ~25 debug topics at 800 Hz for rosbag + PlotJuggler
(reference: include/utils/LeggedLogger.hpp:44-148; hardware launch records 8
topics). Here diagnostics are a dict of time-series arrays, one record a
tick stacked by the caller, saved as compressed .npz with the JAX
package's layout (a `__meta__` JSON entry), so either package's bags load
in the other and in tools/plot_bag.py — same analysis workflows (the
reference's plot_lci.py pandas path maps onto `bag_to_dataframe`, which
needs pandas, an optional dependency).
"""

import json
import os
from typing import Any, Dict

import numpy as np
import torch


def diag_from_loop(loop) -> Dict[str, Any]:
    """Per-tick diagnostic record from a one-robot LoopState (a leading
    axis of 1 on every leaf, which the record drops) — mirrors the channel
    set of the reference's LeggedLogger (actual vs. desired odom/euler,
    joint states and targets, foot positions/targets, contacts, GRFs)."""
    cs, sim = loop.controller, loop.sim
    rec = {
        "root_pos": sim.pos,
        "root_quat": sim.quat,
        "root_lin_vel": sim.vel,
        "root_ang_vel": sim.omega,
        "root_pos_d": cs.ctrl.root_pos_d,
        "root_euler_d": cs.ctrl.root_euler_d,
        "root_pos_est": cs.fbk.root_pos,
        "root_lin_vel_est": cs.fbk.root_lin_vel,
        "joint_pos": sim.q,
        "joint_vel": sim.dq,
        "joint_ang_tgt": cs.ctrl.joint_ang_tgt,
        "joint_tau_tgt": cs.ctrl.joint_tau_tgt,
        "foot_pos_world": cs.fbk.foot_pos_world,
        "foot_pos_target_world": cs.ctrl.foot_pos_target_world,
        "plan_contacts": cs.ctrl.plan_contacts,
        "sim_contacts": sim.contact,
        "grf": cs.ctrl.optimized_input[:, 0:12],
        "foot_force_tau_est": cs.fbk.foot_force_tau_est,
    }
    return {k: v[0] for k, v in rec.items()}


def save_bag(path: str, bag: Dict[str, Any], meta: Dict[str, Any] = None):
    """Save a diagnostics dict (arrays or tensors, leading time axis) as
    .npz with a JSON metadata sidecar entry."""
    flat = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in bag.items()}
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)


def load_bag(path: str):
    """Returns (dict of arrays, metadata dict)."""
    data = np.load(path)
    meta = {}
    out = {}
    for k in data.files:
        if k == "__meta__":
            meta = json.loads(bytes(data[k]).decode())
        else:
            out[k] = data[k]
    return out, meta


def bag_to_dataframe(bag: Dict[str, np.ndarray], dt: float):
    """Flatten a bag into a pandas DataFrame (time-indexed, one column per
    scalar channel) for the reference's pandas/plot workflows
    (reference: scripts/plot_lci.py:22-105)."""
    import pandas as pd

    t = np.arange(next(iter(bag.values())).shape[0]) * dt
    cols = {}
    for name, arr in bag.items():
        arr = np.asarray(arr)
        flat = arr.reshape(arr.shape[0], -1)
        for i in range(flat.shape[1]):
            suffix = f"_{i}" if flat.shape[1] > 1 else ""
            cols[f"{name}{suffix}"] = flat[:, i]
    return pd.DataFrame(cols, index=pd.Index(t, name="t"))
