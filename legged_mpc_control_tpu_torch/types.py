"""State containers (`legged_mpc_control_tpu/types.py`): the functional
replacement of the reference's LeggedState blackboard (LeggedState.h).

Every leaf carries a leading scenario axis B. Leg-indexed fields are
(B, 4, ...) in FL, FR, RL, RR order. Field names follow the JAX package,
which follows the reference, so a JAX `LoopState` converted to numpy
enters the port by name (`loop_state_from_numpy`).
"""

from dataclasses import dataclass

import torch

from legged_mpc_control_tpu_torch.config import resolve_device
from legged_mpc_control_tpu_torch.mpc.gait import GaitLegState
from legged_mpc_control_tpu_torch.ops.filters import MovingWindowState
from legged_mpc_control_tpu_torch.tree import Struct, from_numpy, to_numpy


@dataclass
class Feedback(Struct):
    """Sensor + estimator outputs. reference: LeggedState.h:13-65."""
    root_quat: torch.Tensor           # (B,4) [w,x,y,z]
    root_pos: torch.Tensor            # (B,3)
    root_lin_vel: torch.Tensor        # (B,3) world
    root_euler: torch.Tensor          # (B,3) rpy
    root_rot_mat: torch.Tensor        # (B,3,3) world-from-body
    root_rot_mat_z: torch.Tensor      # (B,3,3) yaw-only
    root_ang_vel: torch.Tensor        # (B,3) world
    imu_acc: torch.Tensor             # (B,3) body
    imu_ang_vel: torch.Tensor         # (B,3) body
    joint_pos: torch.Tensor           # (B,12)
    joint_vel: torch.Tensor           # (B,12)
    joint_tau_est: torch.Tensor       # (B,12)
    foot_force_sensor: torch.Tensor   # (B,4)
    foot_contact_flag: torch.Tensor   # (B,4) sigmoid contact belief
    foot_contact_bool: torch.Tensor   # (B,4) bool, force > threshold
    foot_pos_rel: torch.Tensor        # (B,4,3) body frame
    foot_vel_rel: torch.Tensor        # (B,4,3)
    jac_foot: torch.Tensor            # (B,4,3,3)
    foot_pos_abs: torch.Tensor        # (B,4,3) world axes, CoM origin
    foot_vel_abs: torch.Tensor        # (B,4,3)
    foot_pos_world: torch.Tensor      # (B,4,3)
    foot_vel_world: torch.Tensor      # (B,4,3)
    foot_force_tau_est: torch.Tensor  # (B,4,3) GRF estimate from torques
    estimated_contacts: torch.Tensor  # (B,4)


@dataclass
class Ctrl(Struct):
    """Controller working set. reference: LeggedState.h:67-112."""
    movement_mode: torch.Tensor          # (B,) int32: 0 stand, 1 walk
    root_pos_d: torch.Tensor             # (B,3)
    root_euler_d: torch.Tensor           # (B,3)
    root_lin_vel_d_rel: torch.Tensor     # (B,3) filtered body-frame command
    root_ang_vel_d_rel: torch.Tensor     # (B,3)
    foot_pos_target_world: torch.Tensor  # (B,4,3) Raibert footholds
    foot_pos_target_abs: torch.Tensor    # (B,4,3)
    foot_pos_target_rel: torch.Tensor    # (B,4,3)
    plan_contacts: torch.Tensor          # (B,4)
    optimized_state: torch.Tensor        # (B,18) [pos_d, euler_d, feet]
    optimized_input: torch.Tensor        # (B,24) [GRFs, foot velocities]
    joint_ang_tgt: torch.Tensor          # (B,12)
    joint_vel_tgt: torch.Tensor          # (B,12)
    joint_tau_tgt: torch.Tensor          # (B,12)


@dataclass
class JoyCmd(Struct):
    """Processed operator command. reference: LeggedState.h:114-138."""
    velx: torch.Tensor
    vely: torch.Tensor
    velz: torch.Tensor
    yaw_rate: torch.Tensor
    body_height: torch.Tensor
    ctrl_state: torch.Tensor          # int32
    prev_mode_button: torch.Tensor    # bool
    exit_flag: torch.Tensor           # bool


@dataclass
class KfState(Struct):
    """18-state linear KF (estimation/basic_kf.py in the JAX package). It
    rides the carry; the filter itself comes with kf_type 1."""
    x: torch.Tensor                   # (B,18)
    P: torch.Tensor                   # (B,18,18)
    initialized: torch.Tensor         # (B,) bool


@dataclass
class EkfState(Struct):
    """EKF state (`estimation/ekf.py`), stepped under kf_type 2."""
    x: torch.Tensor                   # (B,25)
    P: torch.Tensor                   # (B,25,25)
    initialized: torch.Tensor         # (B,) bool


@dataclass
class ControllerState(Struct):
    fbk: Feedback
    ctrl: Ctrl
    joy: JoyCmd
    gait: GaitLegState
    kf: KfState
    ekf: EkfState
    vel_filter_x: MovingWindowState
    vel_filter_y: MovingWindowState
    estimation_inited: torch.Tensor   # (B,) bool
    mpc_inited: torch.Tensor          # (B,) bool


def _z(batch, shape, dtype, device):
    return torch.zeros((batch,) + tuple(shape), dtype=dtype, device=device)


def init_feedback(batch, dtype=torch.float32, device="cuda") -> Feedback:
    device = resolve_device(device)

    def z(*shape):
        return _z(batch, shape, dtype, device)
    eye = torch.eye(3, dtype=dtype, device=device)
    quat = z(4)
    quat[:, 0] = 1.0
    return Feedback(
        root_quat=quat, root_pos=z(3), root_lin_vel=z(3), root_euler=z(3),
        root_rot_mat=eye.expand(batch, 3, 3).clone(),
        root_rot_mat_z=eye.expand(batch, 3, 3).clone(),
        root_ang_vel=z(3), imu_acc=z(3), imu_ang_vel=z(3),
        joint_pos=z(12), joint_vel=z(12), joint_tau_est=z(12),
        foot_force_sensor=z(4), foot_contact_flag=z(4),
        foot_contact_bool=_z(batch, (4,), torch.bool, device),
        foot_pos_rel=z(4, 3), foot_vel_rel=z(4, 3),
        jac_foot=eye.expand(batch, 4, 3, 3).clone(),
        foot_pos_abs=z(4, 3), foot_vel_abs=z(4, 3),
        foot_pos_world=z(4, 3), foot_vel_world=z(4, 3),
        foot_force_tau_est=z(4, 3), estimated_contacts=z(4))


def init_ctrl(batch, dtype=torch.float32, device="cuda") -> Ctrl:
    device = resolve_device(device)

    def z(*shape):
        return _z(batch, shape, dtype, device)
    return Ctrl(
        movement_mode=_z(batch, (), torch.int32, device),
        root_pos_d=z(3), root_euler_d=z(3), root_lin_vel_d_rel=z(3),
        root_ang_vel_d_rel=z(3), foot_pos_target_world=z(4, 3),
        foot_pos_target_abs=z(4, 3), foot_pos_target_rel=z(4, 3),
        plan_contacts=torch.ones((batch, 4), dtype=dtype, device=device),
        optimized_state=z(18), optimized_input=z(24),
        joint_ang_tgt=z(12), joint_vel_tgt=z(12), joint_tau_tgt=z(12))


def init_joy(batch, dtype=torch.float32, device="cuda",
             body_height=0.3) -> JoyCmd:
    device = resolve_device(device)

    def z():
        return _z(batch, (), dtype, device)
    return JoyCmd(
        velx=z(), vely=z(), velz=z(), yaw_rate=z(),
        body_height=torch.full((batch,), body_height, dtype=dtype,
                               device=device),
        ctrl_state=_z(batch, (), torch.int32, device),
        prev_mode_button=_z(batch, (), torch.bool, device),
        exit_flag=_z(batch, (), torch.bool, device))


def loop_state_from_numpy(tree, device=None):
    """`control.step.LoopState` from a tree of arrays keyed by field name:
    a JAX LoopState through `np.asarray` (batched on every leaf), or the
    nested dicts of `loop_state_to_numpy`. dtypes are kept."""
    from legged_mpc_control_tpu_torch.control.step import LoopState

    return from_numpy(LoopState, tree, device)


def wb_loop_state_from_numpy(tree, device=None):
    """`control.step.LoopState` with a `sim.wb_sim.WbSimState` (the
    articulated twin's loop, e.g. `runner.init_wb_loop_batch`) from a tree
    of arrays keyed by field name, as `loop_state_from_numpy`."""
    from legged_mpc_control_tpu_torch.control.step import LoopState
    from legged_mpc_control_tpu_torch.sim.wb_sim import WbSimState

    def field(name):
        return tree[name] if isinstance(tree, dict) else getattr(tree, name)
    return LoopState(
        controller=from_numpy(ControllerState, field("controller"), device),
        sim=from_numpy(WbSimState, field("sim"), device))


def loop_state_to_numpy(state) -> dict:
    """Nested dict of numpy arrays, field name -> value."""
    return to_numpy(state)
