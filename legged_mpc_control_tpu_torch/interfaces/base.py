"""Abstract host-side interface (reference: BaseInterface.h:38-43).

The reference's pure-virtual surface is `ctrl_update / fbk_update /
send_cmd`. Here `ctrl_update` lives on device (control/step.py); host
adapters only implement the sensor and command edges.
"""

import abc
from typing import Dict, Optional

import numpy as np


class BaseInterface(abc.ABC):
    """Adapter between the pure control step and a robot/simulator."""

    @abc.abstractmethod
    def fbk_update(self) -> Optional[Dict[str, np.ndarray]]:
        """Return the latest raw sensor frame as the `sensors_raw` dict
        consumed by `control.step.feedback_update` (keys: quat, imu_acc,
        imu_ang_vel, joint_pos, joint_vel, foot_force_sensor,
        joint_tau_est; sim adds pos/vel ground truth), or None if no fresh
        frame is available yet (reference: fbk_update,
        BaseInterface.h:40)."""

    @abc.abstractmethod
    def send_cmd(self, q_tgt, dq_tgt, tau_ff, kp, kd) -> bool:
        """Transmit joint targets; returns False if the command was blocked
        (reference: send_cmd, BaseInterface.h:41 + safety gating,
        GazeboInterface.cpp:80-87)."""

    def close(self) -> None:
        """Release host resources (sockets, native runtime)."""
