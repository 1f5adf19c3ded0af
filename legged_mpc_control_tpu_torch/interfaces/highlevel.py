"""High-level velocity-command bridge (Unitree built-in controller).

Re-design of the reference's `unitree_highlevel_ctrl` node (reference:
src/legged_ctrl/src/unitree_highlevel_ctrl/unitree_highlevel_ctrl.cpp —
a standalone 100 Hz loop that maps joystick commands into the SDK's
`HighCmd` walk commands over UDP, local 8090 -> robot 192.168.123.161:8082
per UnitreeComm.hpp:28, and republishes proprioception for estimation
research, :73-185).

The packet codec here is this framework's own compact fixed-layout format
(magic + mode/gait + velocity + CRC32) — the vendor SDK's 114-byte HighCmd
struct is not reproduced; a thin on-robot shim (or the SDK itself) adapts.
"""

import socket
import struct
import threading
import time
import zlib
from typing import NamedTuple, Optional

MAGIC = 0x4C48_4331          # "LHC1"
_FMT = "<IBBfffff"           # magic, mode, gait, vx, vy, yaw_rate,
                             # body_height, foot_height
_SIZE = struct.calcsize(_FMT)


class HighCmd(NamedTuple):
    mode: int = 2            # 0 idle, 1 force stand, 2 walk
    gait_type: int = 1       # 0 idle, 1 trot, 2 trot running, 3 stairs
    vx: float = 0.0
    vy: float = 0.0
    yaw_rate: float = 0.0
    body_height: float = 0.0  # delta from nominal
    foot_height: float = 0.0  # swing clearance delta


def encode_high_cmd(cmd: HighCmd) -> bytes:
    body = struct.pack(_FMT, MAGIC, cmd.mode & 0xFF, cmd.gait_type & 0xFF,
                       cmd.vx, cmd.vy, cmd.yaw_rate, cmd.body_height,
                       cmd.foot_height)
    return body + struct.pack("<I", zlib.crc32(body))


def decode_high_cmd(data: bytes) -> Optional[HighCmd]:
    if len(data) != _SIZE + 4:
        return None
    body, (crc,) = data[:_SIZE], struct.unpack("<I", data[_SIZE:])
    if zlib.crc32(body) != crc:
        return None
    magic, mode, gait, vx, vy, yaw, h, fh = struct.unpack(_FMT, body)
    if magic != MAGIC:
        return None
    return HighCmd(mode, gait, vx, vy, yaw, h, fh)


class HighLevelBridge:
    """100 Hz command pump (reference loop rate:
    unitree_highlevel_ctrl.cpp:38). Call `set_cmd` from anywhere; the
    background thread keeps transmitting the latest command at a fixed
    rate with absolute-deadline pacing."""

    def __init__(self, peer=("127.0.0.1", 8082), bind=("0.0.0.0", 0),
                 rate_hz: float = 100.0):
        self.peer = peer
        self.period = 1.0 / rate_hz
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(bind)
        self._cmd = HighCmd()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.tx_packets = 0

    def set_cmd(self, **kwargs):
        with self._lock:
            self._cmd = self._cmd._replace(**kwargs)

    def start(self):
        self._thread.start()

    def _run(self):
        next_t = time.monotonic()
        while not self._stop.is_set():
            with self._lock:
                pkt = encode_high_cmd(self._cmd)
            try:
                self.sock.sendto(pkt, self.peer)
                self.tx_packets += 1
            except OSError:
                break
            next_t += self.period
            delay = next_t - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            else:                       # overrun: resync, don't burst
                next_t = time.monotonic()

    def close(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=1.0)
        self.sock.close()
