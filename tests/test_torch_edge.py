"""The port's copies of the JAX package's numpy-only edge modules
(`interfaces/hardware.py`, `highlevel.py`, `mocap.py`, `joystick.py`,
`base.py`) and of its native loader (`native.py`), against the originals.

Every case runs once per module, the port's and the JAX package's, and
holds what it computes to the original's output on the same inputs, byte
for byte (for the original, to itself): the joint swap and the
PositionLimit / PowerProtect clamps, the high-level command codec, mocap
frames and the NatNet server-info and model-def packets, joystick frames,
and through `native/*.cpp` the QP oracle and the Unitree codec's struct
sizes. The port's loader builds into its own directory
(`legged_mpc_control_tpu_torch/_build/native/`), never into
`native/build/`; the JAX loader is pointed at a private build of the same
sources here, so that no test writes `native/build/` beside
tests/test_native.py in another worker."""

import os
import socket
import subprocess
import time

import numpy as np
import pytest

from legged_mpc_control_tpu import native as jnative
from legged_mpc_control_tpu.interfaces import hardware as jhw
from legged_mpc_control_tpu.interfaces import highlevel as jhl
from legged_mpc_control_tpu.interfaces import joystick as jjoy
from legged_mpc_control_tpu.interfaces import mocap as jmocap
from legged_mpc_control_tpu_torch import native as tnative
from legged_mpc_control_tpu_torch.interfaces import base as tbase
from legged_mpc_control_tpu_torch.interfaces import hardware as thw
from legged_mpc_control_tpu_torch.interfaces import highlevel as thl
from legged_mpc_control_tpu_torch.interfaces import joystick as tjoy
from legged_mpc_control_tpu_torch.interfaces import mocap as tmocap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = {"port": thw, "jax": jhw}
HL = {"port": thl, "jax": jhl}
MOCAP = {"port": tmocap, "jax": jmocap}
JOY = {"port": tjoy, "jax": jjoy}
BOTH = ["port", "jax"]


@pytest.mark.parametrize("which", BOTH)
def test_joint_swap(which):
    hw = HW[which]
    x = np.random.default_rng(1).standard_normal(12)
    to_int = hw.unitree_to_internal_joints(x)
    assert to_int.tobytes() == jhw.unitree_to_internal_joints(x).tobytes()
    back = hw.internal_to_unitree_joints(to_int)
    assert back.tobytes() == x.tobytes()
    np.testing.assert_array_equal(
        hw.unitree_to_internal_joints(np.arange(12.0))[0:6],
        [3, 4, 5, 0, 1, 2])
    assert issubclass(hw.HardwareInterface, tbase.BaseInterface) == (
        which == "port")


@pytest.mark.parametrize("which", BOTH)
def test_position_and_power_protect(which):
    hw = HW[which]
    rng = np.random.default_rng(2)
    q = 4.0 * rng.standard_normal(12)
    tau = 60.0 * rng.standard_normal(12)
    qp = hw.position_protect(q)
    assert qp.tobytes() == jhw.position_protect(q).tobytes()
    assert np.all(qp <= hw.Q_MAX) and np.all(qp >= hw.Q_MIN)
    for level in (1, 5, 10):
        got = hw.power_protect(tau, level)
        assert got.tobytes() == jhw.power_protect(tau, level).tobytes()
    np.testing.assert_allclose(hw.power_protect(np.full(12, 100.0), 10),
                               33.5)


@pytest.mark.parametrize("which", BOTH)
def test_highlevel_codec(which):
    hl = HL[which]
    cmd = dict(mode=2, gait_type=1, vx=0.4, vy=-0.1, yaw_rate=0.2,
               body_height=0.02, foot_height=0.01)
    pkt = hl.encode_high_cmd(hl.HighCmd(**cmd))
    assert pkt == jhl.encode_high_cmd(jhl.HighCmd(**cmd))
    out = hl.decode_high_cmd(pkt)
    assert tuple(out) == tuple(jhl.decode_high_cmd(pkt))
    bad = bytearray(pkt)
    bad[6] ^= 0xFF
    assert hl.decode_high_cmd(bytes(bad)) is None
    assert hl.decode_high_cmd(pkt[:-1]) is None


@pytest.mark.parametrize("which", BOTH)
def test_mocap_frames(which):
    mc = MOCAP[which]
    bodies = [(7, np.array([1.0, 2.0, 0.5]),
               np.array([0.9238795, 0.0, 0.0, 0.3826834])),
              (3, np.array([-0.1, 0.2, 0.3]), np.array([1.0, 0.0, 0.0, 0.0]))]
    pkt = mc.build_frame(bodies, frame_number=42)
    assert pkt == jmocap.build_frame(bodies, frame_number=42)
    got = mc.parse_frame(pkt)
    want = jmocap.parse_frame(pkt)
    assert [b.body_id for b in got] == [b.body_id for b in want] == [7, 3]
    for g, w in zip(got, want):
        assert g.pos.tobytes() == w.pos.tobytes()
        assert g.quat.tobytes() == w.quat.tobytes()
        for up in ("z", "y"):
            for a, b in zip(mc.pose_to_ekf_measurement(g, up_axis=up),
                            jmocap.pose_to_ekf_measurement(w, up_axis=up)):
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert mc.parse_frame(b"\x05\x00\x00\x00junk") is None


@pytest.mark.parametrize("which", BOTH)
def test_mocap_server_info_and_model_def(which):
    mc = MOCAP[which]
    info = dict(app_name="Motive", app_version=(2, 3, 0, 0),
                natnet_version=(3, 1, 0, 0))
    pkt = mc.build_server_info(**info)
    assert pkt == jmocap.build_server_info(**info)
    assert tuple(mc.parse_server_info(pkt)) == tuple(
        jmocap.parse_server_info(pkt))
    assert mc.build_connect() == jmocap.build_connect()
    assert mc.build_request_model_def() == jmocap.build_request_model_def()

    def model(m):
        return m.ModelDef(
            marker_sets={"go1": ["m1", "m2", "m3"]},
            rigid_bodies=[m.RigidBodyDef("go1_trunk", 7, 0,
                                         np.array([0.0, 0.1, 0.2])),
                          m.RigidBodyDef("gate", 9, 0, np.zeros(3))],
            skeletons={"operator": [
                m.RigidBodyDef("hip", 1, 0, np.zeros(3)),
                m.RigidBodyDef("chest", 2, 1, np.array([0.0, 0.0, 0.3]))]})
    for ver in ((2, 6), (3, 0)):
        pkt = mc.build_model_def(model(mc), natnet_version=ver)
        assert pkt == jmocap.build_model_def(model(jmocap),
                                             natnet_version=ver)
        got = mc.parse_model_def(pkt, natnet_version=ver)
        assert got.marker_sets == {"go1": ["m1", "m2", "m3"]}
        assert got.body_id_for("gate") == 9


def _wait(pred, timeout=3.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("which", BOTH)
def test_joystick_frames(which):
    """The datagram `send_joy` writes, byte for byte, and what a
    `UdpJoystick` makes of it (the tapped button latched once)."""
    joy = JOY[which]
    axes, buttons = [0.1, 0.0, 0.0, 0.2, 0.8], [1, 0, 0, 0, 0, 0, 1]
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5.0)
    try:
        joy.send_joy(axes, buttons, addr=rx.getsockname())
        jjoy.send_joy(axes, buttons, addr=rx.getsockname())
        assert rx.recvfrom(4096)[0] == rx.recvfrom(4096)[0]
    finally:
        rx.close()
    src = joy.UdpJoystick(bind=("127.0.0.1", 0)).start()
    try:
        joy.send_joy(axes, buttons, addr=src.addr)
        assert _wait(lambda: src.frames >= 1)
        a, b = src.get()
        np.testing.assert_array_equal(a, [0.1, 0.0, 0.0, 0.2, 0.8, 0.0])
        np.testing.assert_array_equal(b, [1, 0, 0, 0, 0, 0])
        joy.send_joy(axes, [0] * 6, addr=src.addr)
        assert _wait(lambda: src.frames >= 2)
        assert src.get()[1][0] == 0.0
    finally:
        src.close()


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    """name -> native loader module: the port's, building into its own
    directory, and the JAX package's, pointed at a private build of the
    same sources (its `_LIB_PATH` and cached library restored after)."""
    tmp = tmp_path_factory.mktemp("jax_native")
    subprocess.run(["make", "-C", os.path.join(REPO, "native"),
                    f"BUILD={tmp}"], check=True, capture_output=True)
    saved = jnative._LIB_PATH, jnative._lib
    jnative._LIB_PATH = str(tmp / "liblegged_native.so")
    jnative._lib = None
    try:
        yield {"port": tnative, "jax": jnative}
    finally:
        jnative._LIB_PATH, jnative._lib = saved


def test_port_loader_builds_into_its_own_directory(loaders):
    lib = tnative.load_library()
    assert tnative.load_library() is lib
    want = os.path.join(REPO, "legged_mpc_control_tpu_torch", "_build",
                        "native", "liblegged_native.so")
    assert os.path.samefile(tnative._LIB_PATH, want)
    assert os.path.exists(want)
    assert not tnative._LIB_PATH.startswith(
        os.path.join(REPO, "native") + os.sep)
    # no make directory is left behind
    assert os.listdir(os.path.dirname(want)) == ["liblegged_native.so"]


def _qp(n=12, m=20, seed=3):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((n, n))
    H = L @ L.T + n * np.eye(n)
    A = rng.standard_normal((m, n))
    lb = -np.abs(rng.standard_normal(m)) - 0.1
    ub = np.abs(rng.standard_normal(m)) + 0.1
    lb[:3] = -1e20
    return H, rng.standard_normal(n), A, lb, ub


@pytest.mark.parametrize("which", BOTH)
def test_native_oracle(loaders, which):
    H, g, A, lb, ub = _qp()
    x = loaders[which].qp_oracle_solve(H, g, A, lb, ub)
    want = loaders["jax"].qp_oracle_solve(H, g, A, lb, ub)
    assert x.tobytes() == want.tobytes()
    r = A @ x
    assert np.all(r >= lb - 1e-6) and np.all(r <= ub + 1e-6)


@pytest.mark.parametrize("which", BOTH)
def test_unitree_codec_struct_sizes(loaders, which):
    codec = loaders[which].UnitreeCodec()
    ref = loaders["jax"].UnitreeCodec()
    sizes = (codec.lowcmd_size, codec.lowstate_size, codec.highcmd_size,
             codec.highstate_size)
    assert sizes == (ref.lowcmd_size, ref.lowstate_size, ref.highcmd_size,
                     ref.highstate_size)
    assert codec.lowcmd_size == 10 + 20 * 33 + 4 * 3 + 40 + 8
    assert codec.lowstate_size == 10 + 53 + 20 * 38 + 8 + 8 + 4 + 40 + 8
    assert codec.highcmd_size == 10 + 1 + 8 * 4 + 4 * 3 + 40 + 40 + 8
    q = np.linspace(-0.5, 0.5, 12)
    pkt = codec.encode_lowcmd(q, q, q, np.full(12, 20.0), np.ones(12))
    assert pkt == ref.encode_lowcmd(q, q, q, np.full(12, 20.0),
                                    np.ones(12))
