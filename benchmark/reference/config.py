"""Robot and controller configuration (`legged_mpc_control_tpu/config.py`).

One dataclass of tensors, `RobotParams`. A leaf either has its canonical
rank (`param_base_ndims`), shared by every scenario, or one leading scenario
axis more (domain randomization, `parallel/runner.randomize_params`).

Values mirror the reference's config/gazebo_a1_convex.yaml and
gazebo_go1_convex.yaml, with fallback defaults from LeggedState.cpp:20-209.
"""

from dataclasses import dataclass

import torch

from benchmark.reference.tree import Struct


@dataclass
class RobotParams(Struct):
    """Per-robot physical + controller parameters (all leaves tensors)."""
    mass: torch.Tensor                # scalar
    trunk_inertia: torch.Tensor       # (3,3)
    q_weights: torch.Tensor           # (12,) on state [rpy, pos, omega, v]
    r_weights: torch.Tensor           # (12,) on GRFs
    mu: torch.Tensor                  # friction coefficient
    fz_max: torch.Tensor              # max normal force per foot
    gait_counter_speed: torch.Tensor  # gait cycles per second
    default_foot_pos: torch.Tensor    # (4,3) FL,FR,RL,RR, body frame
    kp_foot: torch.Tensor             # (3,) joint-space kp, all legs
    kd_foot: torch.Tensor             # (3,)
    foot_sensor_min: torch.Tensor
    foot_sensor_max: torch.Tensor
    foot_sensor_ratio: torch.Tensor
    rho_fix: torch.Tensor             # (4,5) [ox, oy, d, lt, lc] per leg
    max_body_height: torch.Tensor
    min_body_height: torch.Tensor


_BASE_NDIMS = dict(
    mass=0, trunk_inertia=2, q_weights=1, r_weights=1, mu=0, fz_max=0,
    gait_counter_speed=0, default_foot_pos=2, kp_foot=1, kd_foot=1,
    foot_sensor_min=0, foot_sensor_max=0, foot_sensor_ratio=0, rho_fix=2,
    max_body_height=0, min_body_height=0)


def param_base_ndims() -> dict:
    """Canonical (unbatched) rank of each RobotParams leaf, by field name —
    what tells a scenario axis from the leg axis of rho_fix when the batch
    is 4."""
    return dict(_BASE_NDIMS)


def resolve_device(device) -> torch.device:
    """The device a constructor builds its state on. Every function that
    creates state from nothing defaults to the card (`device="cuda"`); with
    no card such a call raises instead of building on the CPU unasked.
    Functions handed tensors follow their tensors' device instead."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: pass device='cpu' to "
                           "build the state on the CPU")
    return device


def _rho_fix():
    """A1/Go1 leg geometry (reference: BaseInterface.cpp:76-89)."""
    ox = [0.1805, 0.1805, -0.1805, -0.1805]
    oy = [0.047, -0.047, 0.047, -0.047]
    d = [0.0838, -0.0838, 0.0838, -0.0838]
    lt = [0.21] * 4
    lc = [0.21] * 4
    return [list(r) for r in zip(ox, oy, d, lt, lc)]


def a1_params(dtype=torch.float32, device="cuda") -> RobotParams:
    """Unitree A1. reference: config/gazebo_a1_convex.yaml."""
    device = resolve_device(device)

    def f(v):
        return torch.tensor(v, dtype=dtype, device=device)
    return RobotParams(
        mass=f(13.0),
        trunk_inertia=torch.diag(f([0.0158533, 0.0377999, 0.0456542])),
        q_weights=f([60.0, 100.0, 0.0, 0.0, 0.0, 450.0,
                     0.15, 0.15, 100.0, 3.0, 3.0, 5.0]),
        r_weights=f([1e-4] * 12),
        mu=f(0.3),
        fz_max=f(180.0),
        gait_counter_speed=f(3.5),
        default_foot_pos=f([[0.17, 0.17, -0.3], [0.17, -0.17, -0.3],
                            [-0.17, 0.17, -0.3], [-0.17, -0.17, -0.3]]),
        kp_foot=f([15.0, 15.0, 15.0]),
        kd_foot=f([0.4, 0.4, 0.4]),
        foot_sensor_min=f(0.0),
        foot_sensor_max=f(200.0),
        foot_sensor_ratio=f(0.5),
        rho_fix=f(_rho_fix()),
        max_body_height=f(0.30),
        min_body_height=f(0.03),
    )


def go1_params(dtype=torch.float32, device="cuda") -> RobotParams:
    """Unitree Go1. reference: config/gazebo_go1_convex.yaml, with the
    hardware joint PD gains (kp 30 / kd 1.5), as the JAX package uses."""
    device = resolve_device(device)

    def f(v):
        return torch.tensor(v, dtype=dtype, device=device)
    return a1_params(dtype, device).replace(
        q_weights=f([50.0, 100.0, 0.0, 0.0, 0.0, 3500.0,
                     0.01, 0.01, 10.0, 15.0, 15.0, 20.0]),
        gait_counter_speed=f(4.0),
        default_foot_pos=f([[0.17, 0.12, -0.3], [0.17, -0.12, -0.3],
                            [-0.17, 0.12, -0.3], [-0.17, -0.12, -0.3]]),
        kp_foot=f([30.0, 30.0, 30.0]),
        kd_foot=f([1.5, 1.5, 1.5]),
        foot_sensor_max=f(300.0),
    )


# The keys a flat config file may hold: what `load_yaml_params` reads, and
# the run-level switches the files carry for the launcher (mpc_type,
# kf_type), which the loader leaves to it.
