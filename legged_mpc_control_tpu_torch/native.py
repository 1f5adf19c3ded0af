"""ctypes bindings for the native runtime + QP oracle (the port's copy of
`legged_mpc_control_tpu/native.py`).

Builds `native/*.cpp` on demand with the repository's unchanged
`native/Makefile` (g++, no external deps) into the port's own git-ignored
build directory, `legged_mpc_control_tpu_torch/_build/native/`, never into
`native/build/`, which the JAX package's loader owns: two `make`s writing
one `.so` would race. Each build goes to a private directory and is
renamed into place, so two processes of the port cannot race either.
Provides:
  * `qp_oracle_solve` — the float64 active-set CPU QP oracle (the
    qpOASES-equivalent ground truth for GRF deviation checks);
  * `Runtime` — the real-time UDP control-loop host (seqlock state
    exchange, absolute-deadline pacing, Unitree-shaped packet codec).
"""

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build", "native")
_LIB_NAME = "liblegged_native.so"
_LIB_PATH = os.path.join(_BUILD_DIR, _LIB_NAME)
_lib: Optional[ctypes.CDLL] = None


def _build():
    """make into a fresh private directory, then rename the library into
    `_LIB_PATH` (atomic on one file system: a reader sees the old file or
    the whole new one)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="make-", dir=_BUILD_DIR)
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, f"BUILD={tmp}"],
                       check=True, capture_output=True)
        os.replace(os.path.join(tmp, _LIB_NAME), _LIB_PATH)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _build()
    lib = ctypes.CDLL(_LIB_PATH)

    d = ctypes.POINTER(ctypes.c_double)
    f = ctypes.POINTER(ctypes.c_float)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.qp_oracle_solve.restype = ctypes.c_int
    lib.qp_oracle_solve.argtypes = [ctypes.c_int, ctypes.c_int, d, d, d, d,
                                    d, ctypes.c_int, ctypes.c_int, d]
    lib.rt_create.restype = ctypes.c_void_p
    lib.rt_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                              ctypes.c_uint64]
    lib.rt_set_peer.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int]
    lib.rt_start.restype = ctypes.c_int
    lib.rt_start.argtypes = [ctypes.c_void_p]
    lib.rt_stop.argtypes = [ctypes.c_void_p]
    lib.rt_destroy.argtypes = [ctypes.c_void_p]
    lib.rt_push_cmd.argtypes = [ctypes.c_void_p, f, f, f, f, f]
    lib.rt_get_state.restype = ctypes.c_uint32
    lib.rt_get_state.argtypes = [ctypes.c_void_p] + [f] * 7
    lib.rt_get_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
    lib.rt_encode_state.restype = ctypes.c_int
    lib.rt_encode_state.argtypes = [f, f, f, f, f, f, f, ctypes.c_uint32,
                                    u8, ctypes.c_int]
    lib.rt_decode_cmd.restype = ctypes.c_int
    lib.rt_decode_cmd.argtypes = [u8, ctypes.c_int, f, f, f, f, f,
                                  ctypes.POINTER(ctypes.c_uint32)]
    # Unitree legged_sdk v3.2 wire codec (native/unitree_codec.cpp)
    for name in ("unitree_lowcmd_size", "unitree_lowstate_size",
                 "unitree_highcmd_size", "unitree_highstate_size"):
        getattr(lib, name).restype = ctypes.c_int
    lib.unitree_crc32.restype = ctypes.c_uint32
    lib.unitree_crc32.argtypes = [u8, ctypes.c_int]
    lib.unitree_lowcmd_encode.restype = ctypes.c_int
    lib.unitree_lowcmd_encode.argtypes = [f, f, f, f, f, f, ctypes.c_int,
                                          u8, ctypes.c_int]
    lib.unitree_lowcmd_decode.restype = ctypes.c_int
    lib.unitree_lowcmd_decode.argtypes = [u8, ctypes.c_int, f, f, f, f, f]
    lib.unitree_lowstate_encode.restype = ctypes.c_int
    lib.unitree_lowstate_encode.argtypes = [f, f, f, f, f, f, f,
                                            ctypes.c_uint32, u8,
                                            ctypes.c_int]
    lib.unitree_lowstate_decode.restype = ctypes.c_int
    lib.unitree_lowstate_decode.argtypes = [u8, ctypes.c_int, f, f, f, f, f,
                                            f, f,
                                            ctypes.POINTER(ctypes.c_uint32)]
    lib.unitree_highcmd_encode.restype = ctypes.c_int
    lib.unitree_highcmd_encode.argtypes = [ctypes.c_uint8] + [
        ctypes.c_float] * 8 + [u8, ctypes.c_int]
    lib.unitree_highstate_decode.restype = ctypes.c_int
    lib.unitree_highstate_decode.argtypes = [u8, ctypes.c_int, f, f, f, f, f]
    _lib = lib
    return lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def qp_oracle_solve(H, g, A, lb, ub, admm_iters=4000, polish_rounds=300):
    """Native float64 QP oracle: min 1/2 x'Hx + g'x, lb <= Ax <= ub."""
    lib = load_library()
    H = np.ascontiguousarray(H, dtype=np.float64)
    g = np.ascontiguousarray(g, dtype=np.float64)
    A = np.ascontiguousarray(A, dtype=np.float64)
    lb = np.ascontiguousarray(lb, dtype=np.float64)
    ub = np.ascontiguousarray(ub, dtype=np.float64)
    n, m = H.shape[0], A.shape[0]
    x = np.zeros(n, dtype=np.float64)
    rc = lib.qp_oracle_solve(n, m, _dptr(H), _dptr(g), _dptr(A), _dptr(lb),
                             _dptr(ub), admm_iters, polish_rounds, _dptr(x))
    if rc != 0:
        raise RuntimeError(f"qp_oracle_solve failed rc={rc}")
    return x


class Runtime:
    """Real-time UDP control-loop host (see native/realtime.cpp)."""

    def __init__(self, bind_ip="127.0.0.1", bind_port=0, period_s=0.00125):
        self._lib = load_library()
        self._h = self._lib.rt_create(bind_ip.encode(), bind_port,
                                      int(period_s * 1e9))
        if not self._h:
            raise RuntimeError("rt_create failed")

    def set_peer(self, ip, port):
        self._lib.rt_set_peer(self._h, ip.encode(), port)

    def start(self):
        if self._lib.rt_start(self._h) != 0:
            raise RuntimeError("rt_start failed")

    def stop(self):
        self._lib.rt_stop(self._h)

    def close(self):
        if self._h:
            self._lib.rt_destroy(self._h)
            self._h = None

    def push_cmd(self, q, dq, kp, kd, tau):
        arrs = [np.ascontiguousarray(a, dtype=np.float32)
                for a in (q, dq, kp, kd, tau)]
        self._lib.rt_push_cmd(self._h, *[_fptr(a) for a in arrs])

    def get_state(self):
        quat = np.zeros(4, np.float32)
        gyro = np.zeros(3, np.float32)
        acc = np.zeros(3, np.float32)
        q = np.zeros(12, np.float32)
        dq = np.zeros(12, np.float32)
        tau = np.zeros(12, np.float32)
        ff = np.zeros(4, np.float32)
        seq = self._lib.rt_get_state(
            self._h, _fptr(quat), _fptr(gyro), _fptr(acc), _fptr(q),
            _fptr(dq), _fptr(tau), _fptr(ff))
        if seq == 0:
            return None
        return dict(seq=seq, quat=quat, gyro=gyro, acc=acc, q=q, dq=dq,
                    tau_est=tau, foot_force=ff)

    def stats(self):
        vals = [ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_double(),
                ctypes.c_double(), ctypes.c_uint64(), ctypes.c_uint64(),
                ctypes.c_uint64()]
        self._lib.rt_get_stats(self._h, *[ctypes.byref(v) for v in vals])
        keys = ["iterations", "overruns", "max_jitter_us", "mean_jitter_us",
                "rx_packets", "tx_packets", "crc_errors"]
        return {k: v.value for k, v in zip(keys, vals)}


def encode_state_packet(quat, gyro, acc, q, dq, tau_est, foot_force, seq=1):
    lib = load_library()
    buf = np.zeros(512, dtype=np.uint8)
    args = [np.ascontiguousarray(a, dtype=np.float32)
            for a in (quat, gyro, acc, q, dq, tau_est, foot_force)]
    n = lib.rt_encode_state(*[_fptr(a) for a in args], seq,
                            buf.ctypes.data_as(
                                ctypes.POINTER(ctypes.c_uint8)), 512)
    if n <= 0:
        raise RuntimeError("encode failed")
    return bytes(buf[:n])


class UnitreeCodec:
    """Unitree legged_sdk v3.2 wire protocol (LowCmd/LowState/HighCmd) —
    the byte layout + crc32_core the reference speaks to real hardware
    (reference: HardwareInterface.cpp:86-120, UnitreeComm.hpp:28). All
    joint/foot arrays are INTERNAL order (FL,FR,RL,RR); the codec performs
    the wire-order swap (HardwareInterface.cpp:27-28) and applies the SDK
    Safety equivalents (PositionLimit + PowerProtect) on encode."""

    def __init__(self):
        self._lib = load_library()
        self.lowcmd_size = self._lib.unitree_lowcmd_size()
        self.lowstate_size = self._lib.unitree_lowstate_size()
        self.highcmd_size = self._lib.unitree_highcmd_size()
        self.highstate_size = self._lib.unitree_highstate_size()

    @staticmethod
    def _f32(a):
        return np.ascontiguousarray(a, dtype=np.float32)

    def encode_lowcmd(self, q, dq, tau, kp, kd, q_state=None,
                      power_protect_level=10) -> bytes:
        buf = np.zeros(self.lowcmd_size, dtype=np.uint8)
        qs = self._f32(q_state if q_state is not None else q)
        args = [self._f32(a) for a in (q, dq, tau, kp, kd)]
        n = self._lib.unitree_lowcmd_encode(
            *[_fptr(a) for a in args], _fptr(qs),
            int(power_protect_level),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.lowcmd_size)
        if n <= 0:
            raise RuntimeError(f"lowcmd encode failed: {n}")
        return bytes(buf[:n])

    def decode_lowcmd(self, data: bytes):
        buf = np.frombuffer(data, dtype=np.uint8).copy()
        out = [np.zeros(12, np.float32) for _ in range(5)]
        rc = self._lib.unitree_lowcmd_decode(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            *[_fptr(a) for a in out])
        if rc != 0:
            raise ValueError(f"lowcmd decode failed rc={rc}")
        return dict(zip(("q", "dq", "tau", "kp", "kd"), out))

    def encode_lowstate(self, quat, gyro, acc, q, dq, tau_est, foot_force,
                        tick=0) -> bytes:
        buf = np.zeros(self.lowstate_size, dtype=np.uint8)
        args = [self._f32(a)
                for a in (quat, gyro, acc, q, dq, tau_est, foot_force)]
        n = self._lib.unitree_lowstate_encode(
            *[_fptr(a) for a in args], int(tick),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.lowstate_size)
        if n <= 0:
            raise RuntimeError(f"lowstate encode failed: {n}")
        return bytes(buf[:n])

    def decode_lowstate(self, data: bytes):
        buf = np.frombuffer(data, dtype=np.uint8).copy()
        quat = np.zeros(4, np.float32)
        gyro = np.zeros(3, np.float32)
        acc = np.zeros(3, np.float32)
        q = np.zeros(12, np.float32)
        dq = np.zeros(12, np.float32)
        tau = np.zeros(12, np.float32)
        ff = np.zeros(4, np.float32)
        tick = ctypes.c_uint32()
        rc = self._lib.unitree_lowstate_decode(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            _fptr(quat), _fptr(gyro), _fptr(acc), _fptr(q), _fptr(dq),
            _fptr(tau), _fptr(ff), ctypes.byref(tick))
        if rc != 0:
            raise ValueError(f"lowstate decode failed rc={rc}")
        return dict(quat=quat, gyro=gyro, acc=acc, q=q, dq=dq, tau_est=tau,
                    foot_force=ff, tick=tick.value)

    def encode_highcmd(self, mode, forward_speed=0.0, side_speed=0.0,
                       rotate_speed=0.0, body_height=0.0,
                       foot_raise_height=0.0, yaw=0.0, pitch=0.0,
                       roll=0.0) -> bytes:
        buf = np.zeros(self.highcmd_size, dtype=np.uint8)
        n = self._lib.unitree_highcmd_encode(
            int(mode), float(forward_speed), float(side_speed),
            float(rotate_speed), float(body_height),
            float(foot_raise_height), float(yaw), float(pitch),
            float(roll),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.highcmd_size)
        if n <= 0:
            raise RuntimeError(f"highcmd encode failed: {n}")
        return bytes(buf[:n])

    def crc32(self, data: bytes) -> int:
        buf = np.frombuffer(data, dtype=np.uint8).copy()
        return int(self._lib.unitree_crc32(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(buf) // 4))


def decode_cmd_packet(data: bytes):
    lib = load_library()
    buf = np.frombuffer(data, dtype=np.uint8).copy()
    q = np.zeros(12, np.float32)
    dq = np.zeros(12, np.float32)
    kp = np.zeros(12, np.float32)
    kd = np.zeros(12, np.float32)
    tau = np.zeros(12, np.float32)
    seq = ctypes.c_uint32()
    rc = lib.rt_decode_cmd(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        _fptr(q), _fptr(dq), _fptr(kp), _fptr(kd), _fptr(tau),
        ctypes.byref(seq))
    if rc != 0:
        raise RuntimeError(f"decode failed rc={rc}")
    return dict(seq=seq.value, q=q, dq=dq, kp=kp, kd=kd, tau=tau)
