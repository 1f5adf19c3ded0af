"""Hardware interface: Unitree-protocol UDP via the native real-time runtime.

Re-design of the reference's `HardwareInterface`
(reference: src/legged_ctrl/src/interfaces/HardwareInterface.cpp):
  * low-level UDP link (reference binds local 8090 -> robot
    192.168.123.10:8007, :7) — here carried by the C++ runtime
    (native/realtime.cpp: absolute-deadline pacing, seqlock state exchange,
    CRC'd packets), so Python never sits on the real-time path;
  * Unitree <-> internal joint/foot index swap (reference: :27-28 — the SDK
    orders legs FR,FL,RR,RL while the controller uses FL,FR,RL,RR);
  * foot-force bias capture on the first frames + moving-average filters
    (reference: :30-36, 161-173);
  * joint-velocity smoothing filters (reference: :137-160, 10-tap);
  * PositionLimit / PowerProtect command guards (reference: :113-115 calls
    the SDK's `Safety` — re-implemented here as explicit clamps).
"""

from typing import Dict, Optional

import numpy as np

from legged_mpc_control_tpu_torch.interfaces.base import BaseInterface

# leg index maps: internal FL,FR,RL,RR <-> Unitree FR,FL,RR,RL
# (reference: HardwareInterface.cpp:27-28 swap tables)
UNITREE_LEG_OF_INTERNAL = np.array([1, 0, 3, 2])
INTERNAL_LEG_OF_UNITREE = np.array([1, 0, 3, 2])   # involution


def _joint_perm(leg_map):
    return np.concatenate([leg_map * 3 + j for j in range(3)]
                          ).reshape(3, 4).T.reshape(-1)


# joint permutations (12,): x_internal = x_unitree[UNITREE_JOINT_PERM]
UNITREE_JOINT_PERM = _joint_perm(UNITREE_LEG_OF_INTERNAL)
INTERNAL_JOINT_PERM = _joint_perm(INTERNAL_LEG_OF_UNITREE)

# A1 joint mechanical limits [hip, thigh, calf]
# (reference: unitree SDK Safety::PositionLimit; a1_description const.xacro)
Q_MIN = np.tile(np.array([-0.802, -1.05, -2.70]), 4)
Q_MAX = np.tile(np.array([0.802, 4.19, -0.916]), 4)
# torque limit (reference: WBC torque-limit task, config/task.info:225-230)
TAU_LIMIT = 33.5


def unitree_to_internal_joints(x_unitree: np.ndarray) -> np.ndarray:
    """Reorder a 12-vector from SDK order (FR,FL,RR,RL) to internal
    (FL,FR,RL,RR)."""
    return np.asarray(x_unitree)[UNITREE_JOINT_PERM]


def internal_to_unitree_joints(x_internal: np.ndarray) -> np.ndarray:
    return np.asarray(x_internal)[INTERNAL_JOINT_PERM]


def position_protect(q_tgt: np.ndarray, margin: float = 0.0) -> np.ndarray:
    """Clamp joint targets to mechanical limits (reference:
    safe.PositionLimit, HardwareInterface.cpp:113)."""
    return np.clip(q_tgt, Q_MIN + margin, Q_MAX - margin)


def power_protect(tau: np.ndarray, level: int = 10) -> np.ndarray:
    """Torque clamp scaled by protection level 1..10 (reference:
    safe.PowerProtect(cmd, state, 10), HardwareInterface.cpp:114)."""
    cap = TAU_LIMIT * (level / 10.0)
    return np.clip(tau, -cap, cap)


class _MovingAverage:
    """Host-side O(1) moving average (reference: MovingWindowFilter.hpp,
    used at 40 taps for foot force and 10 for joint velocity,
    HardwareInterface.cpp:30-36)."""

    def __init__(self, window: int, dim: int):
        self.buf = np.zeros((window, dim))
        self.idx = 0
        self.count = 0

    def update(self, x):
        self.buf[self.idx % len(self.buf)] = x
        self.idx += 1
        self.count = min(self.count + 1, len(self.buf))
        return self.buf[:self.count].mean(axis=0)


class HardwareInterface(BaseInterface):
    """Talks Unitree-shaped packets through the native runtime.

    SAFETY: like the reference (main.cpp:57-60 stdin confirmation), a real
    robot should only be driven deliberately — pass the robot's address via
    `peer`; the default is loopback for HIL testing against a simulated
    robot process.
    """

    N_BIAS_FRAMES = 100        # foot-force bias capture window
                               # (reference: HardwareInterface.cpp:161-167)

    def __init__(self, bind_ip="127.0.0.1", bind_port=8090,
                 peer=("127.0.0.1", 8007), period_s=0.00125,
                 power_protect_level=10):
        from legged_mpc_control_tpu_torch import native

        self.rt = native.Runtime(bind_ip=bind_ip, bind_port=bind_port,
                                 period_s=period_s)
        self.rt.set_peer(*peer)
        self.level = power_protect_level
        self._force_filter = _MovingAverage(40, 4)
        self._dq_filter = _MovingAverage(10, 12)
        self._force_bias = np.zeros(4)
        self._bias_frames = 0
        self._last_seq = 0
        self._started = False

    def start(self):
        self.rt.start()
        self._started = True

    def fbk_update(self) -> Optional[Dict[str, np.ndarray]]:
        st = self.rt.get_state()
        if st is None or st["seq"] == self._last_seq:
            return None
        self._last_seq = st["seq"]

        # index swap SDK -> internal (reference: :27-28)
        q = unitree_to_internal_joints(st["q"].astype(np.float64))
        dq = unitree_to_internal_joints(st["dq"].astype(np.float64))
        tau = unitree_to_internal_joints(st["tau_est"].astype(np.float64))
        ff = st["foot_force"].astype(np.float64)[UNITREE_LEG_OF_INTERNAL]

        # one-shot force bias capture, then subtraction + smoothing
        # (reference: :30-36, 161-173)
        if self._bias_frames < self.N_BIAS_FRAMES:
            k = self._bias_frames
            self._force_bias = (self._force_bias * k + ff) / (k + 1)
            self._bias_frames += 1
        ff = self._force_filter.update(ff - self._force_bias)
        dq = self._dq_filter.update(dq)

        return dict(
            quat=st["quat"].astype(np.float64),
            imu_acc=st["acc"].astype(np.float64),
            imu_ang_vel=st["gyro"].astype(np.float64),
            joint_pos=q, joint_vel=dq, joint_tau_est=tau,
            foot_force_sensor=ff,
        )

    def send_cmd(self, q_tgt, dq_tgt, tau_ff, kp, kd) -> bool:
        """Fill the LowCmd-shaped packet with q/dq/kp/kd/tau after limit
        guards, in SDK joint order (reference: :86-120)."""
        q = position_protect(np.asarray(q_tgt, dtype=np.float64))
        tau = power_protect(np.asarray(tau_ff, dtype=np.float64), self.level)
        self.rt.push_cmd(
            internal_to_unitree_joints(q),
            internal_to_unitree_joints(np.asarray(dq_tgt)),
            internal_to_unitree_joints(np.broadcast_to(kp, (12,))),
            internal_to_unitree_joints(np.broadcast_to(kd, (12,))),
            internal_to_unitree_joints(tau))
        return True

    def stats(self):
        return self.rt.stats()

    def close(self):
        if self._started:
            self.rt.stop()
        self.rt.close()


class UnitreeHardwareInterface(BaseInterface):
    """Speaks the REAL unitree_legged_sdk v3.2 wire protocol: LowCmd /
    LowState byte layouts + crc32_core over UDP
    (reference: HardwareInterface.cpp:7 — LOWLEVEL, local 8090 ->
    192.168.123.10:8007; codec in native/unitree_codec.cpp). The codec
    applies the SDK Safety equivalents (PositionLimit + PowerProtect level,
    reference: :113-115) on every encode, and this class reproduces the
    reference's foot-force bias capture and moving-average filtering
    (reference: :30-36, 161-173).

    SAFETY: defaults to loopback. Pass the robot address deliberately.
    """

    N_BIAS_FRAMES = 100

    def __init__(self, bind=("0.0.0.0", 8090),
                 peer=("127.0.0.1", 8007), power_protect_level=10):
        import socket

        from legged_mpc_control_tpu_torch import native

        self.codec = native.UnitreeCodec()
        self.peer = peer
        self.level = power_protect_level
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(bind)
        self.sock.setblocking(False)
        self._force_filter = _MovingAverage(40, 4)
        self._dq_filter = _MovingAverage(10, 12)
        self._force_bias = np.zeros(4)
        self._bias_frames = 0
        self._last_q = np.zeros(12, dtype=np.float64)
        self._tick = -1

    def start(self):
        pass                    # socket is live from construction

    def fbk_update(self) -> Optional[Dict[str, np.ndarray]]:
        """Drain the socket, decode the newest valid LowState
        (reference: receive_low_state, HardwareInterface.cpp:137-201)."""
        latest = None
        while True:
            try:
                data, _ = self.sock.recvfrom(4096)
            except BlockingIOError:
                break
            if len(data) == self.codec.lowstate_size:
                latest = data
        if latest is None:
            return None
        try:
            st = self.codec.decode_lowstate(latest)
        except ValueError:
            return None
        if st["tick"] == self._tick:
            return None
        self._tick = st["tick"]

        q = st["q"].astype(np.float64)
        dq = self._dq_filter.update(st["dq"].astype(np.float64))
        ff = st["foot_force"].astype(np.float64)
        if self._bias_frames < self.N_BIAS_FRAMES:
            k = self._bias_frames
            self._force_bias = (self._force_bias * k + ff) / (k + 1)
            self._bias_frames += 1
        ff = self._force_filter.update(ff - self._force_bias)
        self._last_q = q
        return dict(
            quat=st["quat"].astype(np.float64),
            imu_acc=st["acc"].astype(np.float64),
            imu_ang_vel=st["gyro"].astype(np.float64),
            joint_pos=q, joint_vel=dq,
            joint_tau_est=st["tau_est"].astype(np.float64),
            foot_force_sensor=ff,
        )

    def send_cmd(self, q_tgt, dq_tgt, tau_ff, kp, kd) -> bool:
        pkt = self.codec.encode_lowcmd(
            np.asarray(q_tgt), np.asarray(dq_tgt), np.asarray(tau_ff),
            np.broadcast_to(kp, (12,)), np.broadcast_to(kd, (12,)),
            q_state=self._last_q, power_protect_level=self.level)
        self.sock.sendto(pkt, self.peer)
        return True

    def stats(self):
        return {"tick": self._tick, "bias_frames": self._bias_frames}

    def close(self):
        self.sock.close()
