"""Live runtime tuning channel — the reference's gain-update topic
(`legged_mpc_control_tpu/utils/tuning.py`).

The reference subscribes to `/a1_debug/low_level_gains` and swaps the
low-level PD gains while running (reference: BaseInterface.cpp:147-162,
driven by scripts/setGains.py). Here the channel is a tiny UDP/JSON
listener: `RobotParams` is an *argument* of the control step, so any leaf
it carries — gains, mass, friction, command scales — can change between
ticks. The listener thread only parks the latest update in a mailbox; the
control loop applies it at its own tick boundary, so the step never sees a
torn write (the functional fix for the reference's racy blackboard
update). An update keeps each leaf's dtype, device and shape.

Wire format: one JSON object per datagram, keys = RobotParams field names,
values = scalars or nested lists, e.g.
    {"kp_foot": [250.0, 250.0, 300.0], "kd_foot": [2.5, 2.5, 3.0]}

`send_gains` is the setGains.py equivalent.
"""

import json
import socket
import threading
from typing import Optional

import torch

from legged_mpc_control_tpu_torch.config import RobotParams

TUNE_PORT = 9007


class GainTuner:
    """Background UDP listener; `apply(params)` folds the newest update in.

    Only fields that exist on RobotParams are accepted; shapes must match
    the existing leaf (so a bad packet can never change the params'
    structure)."""

    def __init__(self, bind=("127.0.0.1", TUNE_PORT)):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(bind)
        self.sock.settimeout(0.2)
        self.addr = self.sock.getsockname()
        self._lock = threading.Lock()
        self._pending: Optional[dict] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.updates_applied = 0
        self.updates_rejected = 0

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            try:
                data, _ = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                msg = json.loads(data.decode())
                if isinstance(msg, dict):
                    with self._lock:
                        self._pending = msg
            except (ValueError, UnicodeDecodeError):
                self.updates_rejected += 1

    def apply(self, params: RobotParams) -> RobotParams:
        """Fold the newest pending update into `params` (no-op if none)."""
        with self._lock:
            msg, self._pending = self._pending, None
        if not msg:
            return params
        updates = {}
        for key, val in msg.items():
            if not hasattr(params, key):
                self.updates_rejected += 1
                continue
            cur = getattr(params, key)
            new = torch.as_tensor(val, dtype=cur.dtype, device=cur.device)
            if new.shape != cur.shape:
                self.updates_rejected += 1
                continue
            updates[key] = new
        if updates:
            params = params.replace(**updates)
            self.updates_applied += 1
        return params

    def close(self):
        self._stop.set()
        self.sock.close()
        if self._thread.is_alive():
            self._thread.join(timeout=1.0)


def send_gains(updates: dict, addr=("127.0.0.1", TUNE_PORT)):
    """The setGains.py equivalent: push a parameter update at a live run
    (reference: scripts/setGains.py publishing low_level_gains)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.sendto(json.dumps(updates).encode(), addr)
    finally:
        s.close()
