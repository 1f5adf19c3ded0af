"""Joystick processing and the operator's mode FSM
(`legged_mpc_control_tpu/control/joy.py`; the reference's joy_callback and
joy_update, BaseInterface.cpp:122-209), batched over a leading scenario
axis.

The gamepad "callback" is an explicit (axes, buttons) input of the tick;
edge detection keeps the previous mode button in `JoyCmd`.
"""

import torch

from legged_mpc_control_tpu_torch.config import RobotParams
from legged_mpc_control_tpu_torch.types import ControllerState, JoyCmd

# Gamepad mapping (Xbox-style, reference: BaseInterface.cpp:124-145)
AXIS_YAW = 0          # left stick horizontal -> yaw rate
AXIS_HEIGHT = 1       # left stick vertical   -> body height rate (velz)
AXIS_VELY = 3         # right stick horizontal -> lateral velocity
AXIS_VELX = 4         # right stick vertical   -> forward velocity
BUTTON_MODE = 0       # A: toggle stand <-> walk (reference: :171-186)
BUTTON_EXIT = 4       # LB: request shutdown (reference: :141-144, 166-168)

# command scales (reference: the joystick_* keys, BaseInterface.cpp:126-139)
VELX_MAX = 0.5
VELY_MAX = 0.3
YAW_RATE_MAX = 0.8
HEIGHT_RATE = 0.1     # m/s of body-height change at full stick


def joy_process(joy: JoyCmd, axes, buttons, dt,
                params: RobotParams) -> JoyCmd:
    """Raw gamepad state into the command struct, and the mode FSM.

    axes: (B, >=5) sticks in [-1, 1]; buttons: (B, >=5), pressed where
    > 0; params shared or batched on the leading axis."""
    dtype = joy.body_height.dtype
    axes = torch.as_tensor(axes, dtype=dtype, device=joy.body_height.device)
    buttons = torch.as_tensor(buttons, device=joy.body_height.device)

    velx = axes[:, AXIS_VELX] * VELX_MAX
    vely = axes[:, AXIS_VELY] * VELY_MAX
    yaw_rate = axes[:, AXIS_YAW] * YAW_RATE_MAX
    velz = axes[:, AXIS_HEIGHT] * HEIGHT_RATE
    # body-height integration, clamped (reference: BaseInterface.cpp:190-199)
    height = torch.minimum(
        torch.maximum(joy.body_height + velz * dt, params.min_body_height),
        params.max_body_height)

    # stand <-> walk on the mode button's rising edge
    # (reference: ctrl_state_change_request, BaseInterface.cpp:171-186)
    mode_btn = buttons[:, BUTTON_MODE] > 0
    rising = mode_btn & ~joy.prev_mode_button.bool()
    ctrl_state = torch.where(rising, 1 - joy.ctrl_state, joy.ctrl_state)
    exit_flag = joy.exit_flag.bool() | (buttons[:, BUTTON_EXIT] > 0)

    return joy.replace(
        velx=velx, vely=vely, velz=velz, yaw_rate=yaw_rate,
        body_height=height, ctrl_state=ctrl_state.to(joy.ctrl_state.dtype),
        prev_mode_button=mode_btn.to(joy.prev_mode_button.dtype),
        exit_flag=exit_flag.to(joy.exit_flag.dtype))


def joy_update(cs: ControllerState, axes, buttons, dt,
               params: RobotParams) -> ControllerState:
    """One joystick tick: process the gamepad and drive `movement_mode`
    (reference: joy_update in ctrl_update, BaseInterface.cpp:165-209; walking
    needs the estimation initialized, :176-180)."""
    joy = joy_process(cs.joy, axes, buttons, dt, params)
    want_walk = (joy.ctrl_state == 1) & cs.estimation_inited
    movement_mode = want_walk.to(cs.ctrl.movement_mode.dtype)
    return cs.replace(joy=joy,
                      ctrl=cs.ctrl.replace(movement_mode=movement_mode))
