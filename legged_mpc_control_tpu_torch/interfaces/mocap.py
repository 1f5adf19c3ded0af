"""OptiTrack/NatNet motion-capture adapter.

Re-design of the reference's `mocap_optitrack` package (reference:
src/mocap_optitrack/ — a NatNet UDP-multicast client that publishes each
rigid body's pose, consumed by `HardwareInterface::opti_callback` to correct
the EKF, HardwareInterface.cpp:203-228; multicast 224.0.0.1, data port 9000,
command port 1510 per config/mocap.yaml:20-24).

Implemented:
  * `parse_frame` — a NatNet "FrameOfData" (MessageID 7) parser covering the
    rigid-body section (ID, position, orientation quaternion) for the packet
    layout NatNet >= 3.0 streams when marker data is not requested, plus the
    marker-set/other-marker skip logic needed to reach it.
  * The COMMAND-PORT protocol the reference client drives against a live
    Motive server (reference: mocap_node.cpp:86-99 + natnet_messages.cpp
    MessageDispatcher::dispatch): `build_connect`/`parse_server_info`
    (Connect=0 retried until ServerInfo=1 supplies the NatNet version that
    gates frame decoding) and `build_request_model_def`/`parse_model_def`
    (RequestModelDef=4 -> ModelDef=5: named marker sets, rigid bodies with
    IDs/parents/offsets, skeletons) for name->streaming-ID resolution.
  * `MocapClient` — a multicast receiver thread producing the latest pose
    per rigid body, with `connect()` handshake + `request_model_def()`.
  * `pose_to_ekf_measurement` — the coordinate fix-up into [pos, euler] for
    `estimation.ekf.ekf_update_with_opti` (the reference applies the
    equivalent transform in rigid_body_publisher.cpp).
"""

import socket
import struct
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

# NatNet message ids (public protocol; reference:
# natnet_packet_definition.cpp:33-43)
NAT_CONNECT = 0
NAT_SERVERINFO = 1
NAT_REQUEST_MODELDEF = 4
NAT_MODELDEF = 5
NAT_FRAMEOFDATA = 7
NAT_UNRECOGNIZED = 100

MAX_NAMELEN = 256


class RigidBody(NamedTuple):
    body_id: int
    pos: np.ndarray      # (3,)
    quat: np.ndarray     # (4,) [w,x,y,z] (NatNet streams x,y,z,w)


class ServerInfo(NamedTuple):
    app_name: str
    app_version: Tuple[int, int, int, int]
    natnet_version: Tuple[int, int, int, int]


class RigidBodyDef(NamedTuple):
    name: str            # empty pre-2.0 streams
    body_id: int
    parent_id: int
    offset: np.ndarray   # (3,) offset from parent


class ModelDef(NamedTuple):
    marker_sets: Dict[str, List[str]]       # set name -> marker names
    rigid_bodies: List[RigidBodyDef]
    skeletons: Dict[str, List[RigidBodyDef]]

    def body_id_for(self, name: str) -> Optional[int]:
        """Resolve a Motive asset name to its streaming ID — the lookup the
        model-definition request exists for (the YAML in the reference maps
        names to topics; IDs come from the server)."""
        for rb in self.rigid_bodies:
            if rb.name == name:
                return rb.body_id
        return None


def build_connect() -> bytes:
    """Connection request: bare 4-byte header, id=0, no payload
    (reference: ConnectionRequestMessage::serialize)."""
    return struct.pack("<HH", NAT_CONNECT, 0)


def build_request_model_def() -> bytes:
    """Model-definition request: bare header, id=4."""
    return struct.pack("<HH", NAT_REQUEST_MODELDEF, 0)


def build_server_info(app_name="FakeMotive", app_version=(2, 0, 0, 0),
                      natnet_version=(3, 0, 0, 0)) -> bytes:
    """Serialize a ServerInfo reply (tests / HIL fake server): 256-byte
    app-name field + version[4] + natNetVersion[4] (the `Sender` layout,
    reference: natnet_packet_definition.h)."""
    name = app_name.encode()[:MAX_NAMELEN - 1]
    payload = name + b"\0" * (MAX_NAMELEN - len(name))
    payload += bytes(app_version) + bytes(natnet_version)
    return struct.pack("<HH", NAT_SERVERINFO, len(payload)) + payload


def parse_server_info(data: bytes) -> Optional[ServerInfo]:
    """ServerInfo (id 1): sending app name + app/NatNet versions. The
    NatNet version gates how frames decode (reference:
    ServerInfoMessage::deserialize -> DataModel::setVersions)."""
    if len(data) < 4 + MAX_NAMELEN + 8:
        return None
    msg_id, _n = struct.unpack_from("<HH", data, 0)
    if msg_id != NAT_SERVERINFO:
        return None
    raw_name = data[4:4 + MAX_NAMELEN]
    app_name = raw_name.split(b"\0", 1)[0].decode(errors="replace")
    off = 4 + MAX_NAMELEN
    app_ver = tuple(data[off:off + 4])
    nn_ver = tuple(data[off + 4:off + 8])
    return ServerInfo(app_name, app_ver, nn_ver)


def _read_cstr(data: bytes, off: int) -> Tuple[str, int]:
    end = data.index(b"\0", off)
    return data[off:end].decode(errors="replace"), end + 1


def _parse_rb_def(data: bytes, off: int,
                  natnet_version) -> Tuple[RigidBodyDef, int]:
    name = ""
    if natnet_version >= (2, 0):
        name, off = _read_cstr(data, off)
    body_id, parent_id, ox, oy, oz = struct.unpack_from("<ii3f", data, off)
    off += 20
    if natnet_version >= (3, 0):
        # per-marker model section: n, then n*(3f offset) + n*(i label)
        (n_mark,) = struct.unpack_from("<i", data, off)
        off += 4 + n_mark * 16
    return RigidBodyDef(name, body_id, parent_id,
                        np.array([ox, oy, oz])), off


def build_model_def(model: ModelDef,
                    natnet_version=(3, 0)) -> bytes:
    """Serialize a ModelDef reply (tests / HIL fake server)."""
    p = b""
    n_sets = (len(model.marker_sets) + len(model.rigid_bodies)
              + len(model.skeletons))
    p += struct.pack("<i", n_sets)
    for name, markers in model.marker_sets.items():
        p += struct.pack("<i", 0) + name.encode() + b"\0"
        p += struct.pack("<i", len(markers))
        for m in markers:
            p += m.encode() + b"\0"
    for rb in model.rigid_bodies:
        p += struct.pack("<i", 1)
        if natnet_version >= (2, 0):
            p += rb.name.encode() + b"\0"
        p += struct.pack("<ii3f", rb.body_id, rb.parent_id, *rb.offset)
        if natnet_version >= (3, 0):
            p += struct.pack("<i", 0)        # no per-marker model
    for name, rbs in model.skeletons.items():
        p += struct.pack("<i", 2) + name.encode() + b"\0"
        p += struct.pack("<ii", 9000 + len(model.skeletons), len(rbs))
        for rb in rbs:
            if natnet_version >= (2, 0):
                p += rb.name.encode() + b"\0"
            p += struct.pack("<ii3f", rb.body_id, rb.parent_id, *rb.offset)
            if natnet_version >= (3, 0):
                p += struct.pack("<i", 0)
    return struct.pack("<HH", NAT_MODELDEF, len(p)) + p


def parse_model_def(data: bytes,
                    natnet_version=(3, 0)) -> Optional[ModelDef]:
    """ModelDef (id 5): the server's asset database — marker-set names,
    rigid-body name/ID/parent/offset, skeleton hierarchies. The reference
    requests it with RequestModelDef (mocap_node pairs IDs from here with
    the YAML's name->topic map)."""
    if len(data) < 8:
        return None
    msg_id, _n = struct.unpack_from("<HH", data, 0)
    if msg_id != NAT_MODELDEF:
        return None
    off = 4
    (n_sets,) = struct.unpack_from("<i", data, off)
    off += 4
    model = ModelDef({}, [], {})
    for _ in range(n_sets):
        (kind,) = struct.unpack_from("<i", data, off)
        off += 4
        if kind == 0:                        # marker set
            name, off = _read_cstr(data, off)
            (n_mark,) = struct.unpack_from("<i", data, off)
            off += 4
            markers = []
            for _ in range(n_mark):
                m, off = _read_cstr(data, off)
                markers.append(m)
            model.marker_sets[name] = markers
        elif kind == 1:                      # rigid body
            rb, off = _parse_rb_def(data, off, natnet_version)
            model.rigid_bodies.append(rb)
        elif kind == 2:                      # skeleton
            name, off = _read_cstr(data, off)
            _skel_id, n_rb = struct.unpack_from("<ii", data, off)
            off += 8
            rbs = []
            for _ in range(n_rb):
                rb, off = _parse_rb_def(data, off, natnet_version)
                rbs.append(rb)
            model.skeletons[name] = rbs
        else:                                # unknown dataset: cannot skip
            break                            # safely, stop (fwd-compat)
    return model


def build_frame(bodies: List[Tuple[int, np.ndarray, np.ndarray]],
                frame_number: int = 0) -> bytes:
    """Serialize a minimal FrameOfData (no marker sets / labeled markers) —
    used by tests and by the HIL fake server; byte-layout-compatible with
    what `parse_frame` consumes."""
    payload = struct.pack("<i", frame_number)
    payload += struct.pack("<i", 0)          # nMarkerSets
    payload += struct.pack("<i", 0)          # nOtherMarkers
    payload += struct.pack("<i", len(bodies))
    for body_id, pos, quat in bodies:
        w, x, y, z = quat
        payload += struct.pack("<i", body_id)
        payload += struct.pack("<3f", *pos)
        payload += struct.pack("<4f", x, y, z, w)
        payload += struct.pack("<f", 0.0)    # mean marker error
        payload += struct.pack("<h", 1)      # params: tracking valid
    return struct.pack("<HH", NAT_FRAMEOFDATA, len(payload)) + payload


def parse_frame(data: bytes,
                natnet_version=None) -> Optional[List[RigidBody]]:
    """Extract rigid bodies from a FrameOfData packet. Returns None for
    non-frame messages. Unknown trailing sections (skeletons, labeled
    markers, timing) are ignored — the reference client likewise only
    publishes the rigid-body section.

    natnet_version: (major, minor) from the ServerInfo handshake gates the
    per-body trailer exactly as the reference does (mean marker error at
    >= 2.0, params word at >= 2.6 — RigidBodyMessagePart::deserialize);
    None keeps the length-heuristic for un-handshaken captures."""
    if len(data) < 4:
        return None
    msg_id, _nbytes = struct.unpack_from("<HH", data, 0)
    if msg_id != NAT_FRAMEOFDATA:
        return None
    off = 4
    off += 4                                            # frame number
    (n_marker_sets,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_marker_sets):
        end = data.index(b"\0", off)                    # set name (cstr)
        off = end + 1
        (n_markers,) = struct.unpack_from("<i", data, off)
        off += 4 + 12 * n_markers
    (n_other,) = struct.unpack_from("<i", data, off)
    off += 4 + 12 * n_other
    (n_bodies,) = struct.unpack_from("<i", data, off)
    off += 4
    bodies = []
    for _ in range(n_bodies):
        body_id, px, py, pz, qx, qy, qz, qw = struct.unpack_from(
            "<i7f", data, off)
        off += 32
        if natnet_version is None:
            # mean error + params (present in >=2.6 streams)
            if off + 6 <= len(data):
                off += 6
        else:
            if natnet_version >= (2, 0):
                off += 4                     # mean marker error
            if natnet_version >= (2, 6):
                off += 2                     # params (tracking-valid bit)
        bodies.append(RigidBody(
            body_id=body_id,
            pos=np.array([px, py, pz]),
            quat=np.array([qw, qx, qy, qz])))
    return bodies


def pose_to_ekf_measurement(rb: RigidBody, up_axis: str = "z"):
    """NatNet pose -> (pos (3,), euler rpy (3,)) for the EKF's mocap update.

    OptiTrack default streams Y-up; the robot frame is Z-up (the reference's
    publisher applies this rotation, mocap_optitrack rigid_body_publisher).
    """
    pos = rb.pos.copy()
    w, x, y, z = rb.quat
    if up_axis == "y":
        # rotate -90 deg about X: (x,y,z)_yup -> (x, -z, y)_zup
        pos = np.array([pos[0], -pos[2], pos[1]])
        # q_zup = r * q_yup with r = rot_x(+90deg) = (cos45, sin45, 0, 0)
        s = np.sqrt(0.5)
        w, x, y, z = (s * w - s * x, s * x + s * w,
                      s * y - s * z, s * z + s * y)
    # quat -> ZYX euler (same convention as ops/so3.quat_to_euler)
    sinr = 2 * (w * x + y * z)
    cosr = 1 - 2 * (x * x + y * y)
    roll = np.arctan2(sinr, cosr)
    sinp = np.clip(2 * (w * y - z * x), -1.0, 1.0)
    pitch = np.arcsin(sinp)
    siny = 2 * (w * z + x * y)
    cosy = 1 - 2 * (y * y + z * z)
    yaw = np.arctan2(siny, cosy)
    return pos, np.array([roll, pitch, yaw])


class MocapClient:
    """Background multicast receiver; keeps the latest pose per body
    (reference topology: mocap.yaml multicast 224.0.0.1:9000, command
    port 1510).

    Against a real Motive server call `connect()` first: it retries the
    Connect request until ServerInfo arrives (the reference blocks its
    whole init on this, mocap_node.cpp:86-99) and the learned NatNet
    version then gates frame decoding. `request_model_def()` fetches the
    asset database for name->ID resolution."""

    def __init__(self, multicast_group="224.0.0.1", port=9000,
                 iface_ip="0.0.0.0", server_ip=None, command_port=1510):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((iface_ip, port))
        if multicast_group:
            mreq = (socket.inet_aton(multicast_group)
                    + socket.inet_aton(iface_ip))
            self.sock.setsockopt(socket.IPPROTO_IP,
                                 socket.IP_ADD_MEMBERSHIP, mreq)
        self.sock.settimeout(0.2)
        self.server_addr = (server_ip, command_port) if server_ip else None
        self.server_info: Optional[ServerInfo] = None
        self.model_def: Optional[ModelDef] = None
        self.latest: Dict[int, RigidBody] = {}
        self.frames = 0
        self.malformed = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @property
    def _nn_version(self):
        si = self.server_info
        return si.natnet_version[:2] if si else None

    def connect(self, timeout=5.0, retry_s=0.5) -> ServerInfo:
        """Command-port handshake: send Connect until ServerInfo arrives
        (must be called before `start()`; uses the same socket, as the
        reference's UdpMulticastSocket does)."""
        if self.server_addr is None:
            raise RuntimeError("MocapClient(server_ip=...) required")
        deadline = time.monotonic() + timeout
        self.sock.sendto(build_connect(), self.server_addr)
        while time.monotonic() < deadline:
            try:
                data, _ = self.sock.recvfrom(65535)
            except socket.timeout:
                self.sock.sendto(build_connect(), self.server_addr)
                continue
            info = parse_server_info(data)
            if info is not None:
                self.server_info = info
                return info
            # data frames may already be streaming; keep waiting
        raise TimeoutError("no ServerInfo from Motive server")

    def request_model_def(self, timeout=5.0) -> ModelDef:
        """Fetch the server's asset definitions (RequestModelDef ->
        ModelDef). Call after `connect()`, before `start()`."""
        if self.server_addr is None:
            raise RuntimeError("MocapClient(server_ip=...) required")
        deadline = time.monotonic() + timeout
        self.sock.sendto(build_request_model_def(), self.server_addr)
        while time.monotonic() < deadline:
            try:
                data, _ = self.sock.recvfrom(65535)
            except socket.timeout:
                self.sock.sendto(build_request_model_def(),
                                 self.server_addr)
                continue
            model = parse_model_def(data, self._nn_version or (3, 0))
            if model is not None:
                self.model_def = model
                return model
        raise TimeoutError("no ModelDef from Motive server")

    def start(self):
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                data, _ = self.sock.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                bodies = parse_frame(data, self._nn_version)
            except (ValueError, struct.error):
                self.malformed += 1          # truncated/garbage packet
                continue
            if bodies:
                for rb in bodies:
                    self.latest[rb.body_id] = rb
                self.frames += 1

    def get_pose(self, body_id: int) -> Optional[RigidBody]:
        return self.latest.get(body_id)

    def close(self):
        self._stop.set()
        self.sock.close()
        if self._thread.is_alive():
            self._thread.join(timeout=1.0)


class FakeMotiveServer:
    """Minimal Motive command-port responder for tests/HIL: answers
    Connect with ServerInfo and RequestModelDef with the configured model
    (the counterpart of the multicast frame feeder in tests)."""

    def __init__(self, model: ModelDef = None,
                 natnet_version=(3, 0, 0, 0), port=0):
        self.model = model or ModelDef({}, [], {})
        self.natnet_version = natnet_version
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", port))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                data, addr = self.sock.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                break
            if len(data) < 4:
                continue
            (msg_id,) = struct.unpack_from("<H", data, 0)
            if msg_id == NAT_CONNECT:
                self.sock.sendto(
                    build_server_info(natnet_version=self.natnet_version),
                    addr)
            elif msg_id == NAT_REQUEST_MODELDEF:
                self.sock.sendto(
                    build_model_def(self.model,
                                    self.natnet_version[:2]), addr)
            else:
                self.sock.sendto(
                    struct.pack("<HH", NAT_UNRECOGNIZED, 0), addr)

    def close(self):
        self._stop.set()
        self.sock.close()
        if self._thread.is_alive():
            self._thread.join(timeout=1.0)
