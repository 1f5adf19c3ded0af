"""Live joystick input bridge.

The reference consumes a ROS /joy topic (sensor_msgs/Joy) in
`joy_callback` (reference: BaseInterface.cpp:122-145). Here the transport
is a UDP/JSON datagram stream — one object per packet:

    {"axes": [a0..a5], "buttons": [b0..b5]}

with the same axis/button mapping as control/joy.py (Xbox-style). A
background thread parks the newest frame; the control loop samples it at
tick boundaries and feeds it into the pure `joy_update` FSM — the
functional split of the reference's callback-mutates-blackboard design.

Any gamepad reader (evdev, pygame, a phone app) becomes a one-liner that
sends these datagrams; `send_joy` is provided for scripting and tests.
"""

import json
import socket
import threading

import numpy as np

JOY_PORT = 9008
N_AXES = 6
N_BUTTONS = 6


class UdpJoystick:
    def __init__(self, bind=("127.0.0.1", JOY_PORT)):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(bind)
        self.sock.settimeout(0.2)
        self.addr = self.sock.getsockname()
        self._lock = threading.Lock()
        self._axes = np.zeros(N_AXES)
        self._buttons = np.zeros(N_BUTTONS)
        self._prev_buttons = np.zeros(N_BUTTONS)
        # one-shot press latches: a tap that lands entirely between two
        # control-loop samples must still register (the reference latches
        # ctrl_state_change_request in the ROS callback for the same
        # reason, BaseInterface.cpp:126-129)
        self._pressed = np.zeros(N_BUTTONS, dtype=bool)
        self.frames = 0
        self.malformed = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            try:
                data, _ = self.sock.recvfrom(4096)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                msg = json.loads(data.decode())
                axes = np.zeros(N_AXES)
                buttons = np.zeros(N_BUTTONS)
                a = np.asarray(msg.get("axes", []), dtype=np.float64)
                b = np.asarray(msg.get("buttons", []), dtype=np.float64)
                axes[:min(len(a), N_AXES)] = a[:N_AXES]
                buttons[:min(len(b), N_BUTTONS)] = b[:N_BUTTONS]
                with self._lock:
                    self._pressed |= (buttons > 0.5) & (
                        self._prev_buttons <= 0.5)
                    self._prev_buttons = buttons
                    self._axes, self._buttons = axes, buttons
                    self.frames += 1
            except (ValueError, UnicodeDecodeError):
                # counted, not raised: one corrupt datagram must not kill
                # the receiver (the reference's filter warm-up likewise
                # counts bad samples, HardwareInterface.cpp)
                self.malformed += 1

    def get(self):
        """Newest (axes, buttons). Latched presses are delivered exactly
        once: a button that was tapped since the previous `get` reads 1 on
        this sample even if the frame-level press has already ended, and
        the latch clears. Zeros until the first frame arrives."""
        with self._lock:
            buttons = self._buttons.copy()
            buttons[self._pressed] = 1.0
            # only clear latches the sample actually delivered as a press;
            # a still-held button re-latches nothing (edge semantics)
            self._pressed[:] = False
            return self._axes.copy(), buttons

    def close(self):
        self._stop.set()
        self.sock.close()
        if self._thread.is_alive():
            self._thread.join(timeout=1.0)


def send_joy(axes, buttons=(), addr=("127.0.0.1", JOY_PORT)):
    """Push one gamepad frame at a live run."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.sendto(json.dumps({"axes": list(map(float, axes)),
                             "buttons": list(map(float, buttons))}).encode(),
                 addr)
    finally:
        s.close()
