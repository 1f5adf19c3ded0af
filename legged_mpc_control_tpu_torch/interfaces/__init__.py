"""Host-side robot I/O interfaces — the edge of the functional core.

The reference's interface layer (`BaseInterface` -> `GazeboInterface` /
`HardwareInterface`, reference: src/legged_ctrl/include/interfaces/
BaseInterface.h:31-43) is where ROS topics / Unitree UDP meet the
controller. In the port the controller is a set of functions over tensor
dataclasses; these classes are thin host adapters that (a) produce the
`sensors_raw` dict the control step consumes and (b) transmit its joint
commands. The simulation backend keeps the loop on the device; the
hardware backend talks to the native C++ real-time runtime
(native/realtime.cpp) over its seqlock'd packet channel.
"""

from legged_mpc_control_tpu_torch.interfaces.base import BaseInterface
from legged_mpc_control_tpu_torch.interfaces.sim_iface import SimInterface
from legged_mpc_control_tpu_torch.interfaces.hardware import (
    HardwareInterface,
    internal_to_unitree_joints,
    unitree_to_internal_joints,
    position_protect,
    power_protect,
)
