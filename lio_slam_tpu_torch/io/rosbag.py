"""Pure-Python ROS1 bag (format 2.0) reader + message decoders (host-side
numpy; the port's own copy of `lio_slam_tpu/io/rosbag.py`, byte for byte in
what it reads and writes).

The reference's entire validation regime is bag replay (`rosbag play
slope02_01.bag ...`, src/liorf/README.md:137-158).  This module lets the
port's pipeline ingest those same bags with no ROS installation: a minimal
rosbag 2.0 parser (records, chunk decompression, connection index) plus
hand-rolled deserializers for the message types the pipeline consumes:

- ``sensor_msgs/PointCloud2``  -> structured numpy array per scan
- ``sensor_msgs/Imu``          -> orientation/gyro/accel arrays
- ``sensor_msgs/NavSatFix``    -> lat/lon/alt + covariance
- ``nav_msgs/Odometry``        -> pose + twist
- ``sensor_driver_msgs/GpswithHeading`` -> NavSatFix + heading/pitch/roll
  (the 6t vehicle GPS topic, sensor_driver_msgs/msg/GpswithHeading.msg)

Bag format reference: http://wiki.ros.org/Bags/Format/2.0 (public spec).
Supported compression: none, bz2 (stdlib), lz4 if the module is present.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from lio_slam_tpu_torch.io import formats as F

_BAG_MAGIC = b"#ROSBAG V2.0\n"

# record op codes
_OP_BAG_HEADER = 0x03
_OP_CHUNK = 0x05
_OP_CONNECTION = 0x07
_OP_MSG_DATA = 0x02
_OP_INDEX_DATA = 0x04
_OP_CHUNK_INFO = 0x06


def _read_header(buf: bytes) -> Dict[bytes, bytes]:
    """Parse a rosbag record header: sequence of len-prefixed `name=value`."""
    fields: Dict[bytes, bytes] = {}
    i = 0
    n = len(buf)
    while i + 4 <= n:
        (flen,) = struct.unpack_from("<I", buf, i)
        i += 4
        item = buf[i:i + flen]
        i += flen
        eq = item.find(b"=")
        if eq >= 0:
            fields[item[:eq]] = item[eq + 1:]
    return fields


def _records(data: bytes, offset: int = 0) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    """Iterate (header, payload) records from a byte buffer."""
    i = offset
    n = len(data)
    while i + 4 <= n:
        (hlen,) = struct.unpack_from("<I", data, i)
        i += 4
        header = _read_header(data[i:i + hlen])
        i += hlen
        if i + 4 > n:
            break
        (dlen,) = struct.unpack_from("<I", data, i)
        i += 4
        payload = data[i:i + dlen]
        i += dlen
        yield header, payload


@dataclass
class Connection:
    conn_id: int
    topic: str
    msg_type: str
    md5sum: str = ""
    message_definition: str = ""


@dataclass
class BagMessage:
    topic: str
    msg_type: str
    stamp: float          # record receive time (sec)
    raw: bytes            # serialized message body

    def decode(self):
        return decode_message(self.msg_type, self.raw)


@dataclass
class BagReader:
    """Sequential ROS1 bag reader.  Loads the whole file (bags in the
    reference's test sets are single-run recordings; random access via the
    chunk index is unnecessary for replay)."""

    path: str
    connections: Dict[int, Connection] = field(default_factory=dict)

    def read_messages(self, topics: Optional[List[str]] = None
                      ) -> Iterator[BagMessage]:
        want = set(topics) if topics else None
        with open(self.path, "rb") as f:
            magic = f.read(len(_BAG_MAGIC))
            if magic != _BAG_MAGIC:
                raise ValueError(f"not a ROS bag 2.0 file: {self.path!r}")
            data = f.read()
        for header, payload in _records(data):
            op = header.get(b"op", b"\x00")[0]
            if op == _OP_CONNECTION:
                self._add_connection(header, payload)
            elif op == _OP_CHUNK:
                comp = header.get(b"compression", b"none").decode()
                if comp == "bz2":
                    payload = bz2.decompress(payload)
                elif comp == "lz4":
                    try:
                        import lz4.frame  # type: ignore
                    except ImportError as e:  # pragma: no cover
                        raise RuntimeError(
                            "bag uses lz4 compression; lz4 module not "
                            "available — re-record with `rosbag compress "
                            "--bz2`") from e
                    payload = lz4.frame.decompress(payload)
                elif comp != "none":
                    raise ValueError(f"unknown chunk compression {comp!r}")
                yield from self._chunk_messages(payload, want)
            elif op == _OP_MSG_DATA:  # unchunked (rare: bags v2 pre-index)
                msg = self._msg_from_record(header, payload, want)
                if msg is not None:
                    yield msg

    def _add_connection(self, header, payload):
        conn_id = struct.unpack("<I", header[b"conn"])[0]
        topic = header.get(b"topic", b"").decode()
        sub = _read_header(payload)
        self.connections[conn_id] = Connection(
            conn_id=conn_id,
            topic=sub.get(b"topic", topic.encode()).decode() or topic,
            msg_type=sub.get(b"type", b"").decode(),
            md5sum=sub.get(b"md5sum", b"").decode(),
            message_definition=sub.get(b"message_definition", b"").decode())

    def _chunk_messages(self, chunk: bytes, want) -> Iterator[BagMessage]:
        for header, payload in _records(chunk):
            op = header.get(b"op", b"\x00")[0]
            if op == _OP_CONNECTION:
                self._add_connection(header, payload)
            elif op == _OP_MSG_DATA:
                msg = self._msg_from_record(header, payload, want)
                if msg is not None:
                    yield msg

    def _msg_from_record(self, header, payload, want) -> Optional[BagMessage]:
        conn_id = struct.unpack("<I", header[b"conn"])[0]
        conn = self.connections.get(conn_id)
        if conn is None:
            return None
        if want is not None and conn.topic not in want:
            return None
        secs, nsecs = struct.unpack("<II", header[b"time"])
        return BagMessage(topic=conn.topic, msg_type=conn.msg_type,
                          stamp=secs + nsecs * 1e-9, raw=payload)


# ---------------------------------------------------------------------------
# message deserialization (ROS1 little-endian serialization)
# ---------------------------------------------------------------------------


class _Cursor:
    __slots__ = ("buf", "i")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.i = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.i)
        self.i += 4
        return v

    def u8(self) -> int:
        v = self.buf[self.i]
        self.i += 1
        return v

    def f64(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.i)
        self.i += 8
        return v

    def f64s(self, n: int) -> np.ndarray:
        v = np.frombuffer(self.buf, "<f8", n, self.i)
        self.i += 8 * n
        return v

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.i:self.i + n]
        self.i += n
        return s.decode(errors="replace")

    def time(self) -> float:
        secs = self.u32()
        nsecs = self.u32()
        return secs + nsecs * 1e-9

    def header(self) -> Tuple[int, float, str]:
        seq = self.u32()
        stamp = self.time()
        frame = self.string()
        return seq, stamp, frame


_PC2_DTYPES = {1: "i1", 2: "u1", 3: "i2", 4: "u2",
               5: "i4", 6: "u4", 7: "f4", 8: "f8"}


@dataclass
class PointCloud2:
    stamp: float
    frame_id: str
    points: np.ndarray     # structured array, one entry per field
    is_dense: bool

    def field(self, *names: str) -> np.ndarray:
        """First present field among `names` (vendors disagree on naming)."""
        for n in names:
            if n in (self.points.dtype.names or ()):
                return self.points[n]
        raise KeyError(f"none of {names} in {self.points.dtype.names}")

    def xyz(self) -> np.ndarray:
        return np.stack([np.asarray(self.points["x"], np.float32),
                         np.asarray(self.points["y"], np.float32),
                         np.asarray(self.points["z"], np.float32)], axis=1)


def decode_pointcloud2(raw: bytes) -> PointCloud2:
    c = _Cursor(raw)
    _, stamp, frame = c.header()
    height = c.u32()
    width = c.u32()
    nfields = c.u32()
    names, formats, offsets = [], [], []
    for _ in range(nfields):
        name = c.string()
        offset = c.u32()
        datatype = c.u8()
        count = c.u32()
        base = _PC2_DTYPES[datatype]
        names.append(name)
        formats.append(base if count == 1 else (base, (count,)))
        offsets.append(offset)
    is_bigendian = c.u8()
    point_step = c.u32()
    _row_step = c.u32()
    data_len = c.u32()
    data = c.buf[c.i:c.i + data_len]
    c.i += data_len
    is_dense = bool(c.u8())
    if is_bigendian:  # never produced by the supported drivers
        raise ValueError("big-endian PointCloud2 unsupported")
    dtype = np.dtype({"names": names, "formats": formats,
                      "offsets": offsets, "itemsize": point_step})
    n = height * width
    points = np.frombuffer(data, dtype=dtype, count=n)
    return PointCloud2(stamp=stamp, frame_id=frame, points=points,
                       is_dense=is_dense)


@dataclass
class ImuMsg:
    stamp: float
    orientation: np.ndarray          # (4,) x y z w
    angular_velocity: np.ndarray     # (3,)
    linear_acceleration: np.ndarray  # (3,)


def decode_imu(raw: bytes) -> ImuMsg:
    c = _Cursor(raw)
    _, stamp, _ = c.header()
    quat = c.f64s(4).copy()
    c.f64s(9)                        # orientation covariance
    gyro = c.f64s(3).copy()
    c.f64s(9)
    accel = c.f64s(3).copy()
    c.f64s(9)
    return ImuMsg(stamp=stamp, orientation=quat, angular_velocity=gyro,
                  linear_acceleration=accel)


@dataclass
class NavSatFixMsg:
    stamp: float
    status: int
    latitude: float
    longitude: float
    altitude: float
    position_covariance: np.ndarray  # (9,)


def decode_navsatfix(raw: bytes) -> NavSatFixMsg:
    c = _Cursor(raw)
    _, stamp, _ = c.header()
    status = struct.unpack_from("<b", c.buf, c.i)[0]
    c.i += 1
    _service = struct.unpack_from("<H", c.buf, c.i)[0]
    c.i += 2
    lat, lon, alt = c.f64(), c.f64(), c.f64()
    cov = c.f64s(9).copy()
    _cov_type = c.u8()
    return NavSatFixMsg(stamp=stamp, status=status, latitude=lat,
                        longitude=lon, altitude=alt, position_covariance=cov)


@dataclass
class OdometryMsg:
    stamp: float
    frame_id: str
    child_frame_id: str
    position: np.ndarray     # (3,)
    orientation: np.ndarray  # (4,) x y z w
    pose_covariance: np.ndarray  # (36,)
    linear: np.ndarray       # (3,)
    angular: np.ndarray      # (3,)


def decode_odometry(raw: bytes) -> OdometryMsg:
    c = _Cursor(raw)
    _, stamp, frame = c.header()
    child = c.string()
    pos = c.f64s(3).copy()
    quat = c.f64s(4).copy()
    pose_cov = c.f64s(36).copy()
    lin = c.f64s(3).copy()
    ang = c.f64s(3).copy()
    c.f64s(36)               # twist covariance
    return OdometryMsg(stamp=stamp, frame_id=frame, child_frame_id=child,
                       position=pos, orientation=quat,
                       pose_covariance=pose_cov, linear=lin, angular=ang)


@dataclass
class GpswithHeadingMsg:
    """sensor_driver_msgs/GpswithHeading: std_msgs/Header + NavSatFix gps +
    float32 heading/pitch/roll + int8 mode (the 6t GPS topic)."""
    stamp: float
    gps: NavSatFixMsg
    heading: float
    pitch: float
    roll: float
    mode: int


def decode_gps_with_heading(raw: bytes) -> GpswithHeadingMsg:
    c = _Cursor(raw)
    _, stamp, _ = c.header()
    # embedded NavSatFix (with its own header)
    _, gstamp, _ = c.header()
    status = struct.unpack_from("<b", c.buf, c.i)[0]
    c.i += 1
    c.i += 2  # service
    lat, lon, alt = c.f64(), c.f64(), c.f64()
    cov = c.f64s(9).copy()
    c.i += 1  # covariance type
    gps = NavSatFixMsg(stamp=gstamp, status=status, latitude=lat,
                       longitude=lon, altitude=alt, position_covariance=cov)
    heading, pitch, roll = struct.unpack_from("<fff", c.buf, c.i)
    c.i += 12
    mode = struct.unpack_from("<b", c.buf, c.i)[0]
    return GpswithHeadingMsg(stamp=stamp, gps=gps, heading=heading,
                             pitch=pitch, roll=roll, mode=mode)


_DECODERS = {
    "sensor_msgs/PointCloud2": decode_pointcloud2,
    "sensor_msgs/Imu": decode_imu,
    "sensor_msgs/NavSatFix": decode_navsatfix,
    "nav_msgs/Odometry": decode_odometry,
    "sensor_driver_msgs/GpswithHeading": decode_gps_with_heading,
}


def decode_message(msg_type: str, raw: bytes):
    dec = _DECODERS.get(msg_type)
    if dec is None:
        raise KeyError(f"no decoder for {msg_type!r} "
                       f"(supported: {sorted(_DECODERS)})")
    return dec(raw)


# ---------------------------------------------------------------------------
# scan adaptation: PointCloud2 -> StandardScan via the vendor registry
# ---------------------------------------------------------------------------


def scan_from_pointcloud2(pc2: PointCloud2, sensor: str = "velodyne"):
    """Route a decoded cloud through the right `io.formats` adapter
    (imageProjection.cpp:224-286 vendor dispatch)."""
    xyz = pc2.xyz()
    names = pc2.points.dtype.names or ()
    intensity = (np.asarray(pc2.field("intensity"), np.float32)
                 if "intensity" in names else np.zeros(len(xyz), np.float32))
    if sensor == "velodyne":
        ring = np.asarray(pc2.field("ring"), np.uint16)
        time = np.asarray(pc2.field("time", "t"), np.float32)
        return F.from_velodyne(xyz, intensity, ring, time, pc2.stamp)
    if sensor == "ouster":
        ring = np.asarray(pc2.field("ring"), np.uint16)
        t_ns = np.asarray(pc2.field("t", "time"), np.int64)
        return F.from_ouster(xyz, intensity, ring, t_ns, pc2.stamp)
    if sensor == "robosense":
        ring = np.asarray(pc2.field("ring"), np.uint16)
        ts = np.asarray(pc2.field("timestamp"), np.float64)
        return F.from_robosense(xyz, intensity, ring, ts, pc2.stamp)
    if sensor == "mulran":
        ring = np.asarray(pc2.field("ring"), np.uint16)
        t_us = np.asarray(pc2.field("t", "time"), np.float64)
        return F.from_mulran(xyz, intensity, ring, t_us, pc2.stamp)
    if sensor == "livox":
        line = np.asarray(pc2.field("line", "ring"), np.uint16)
        time = np.asarray(pc2.field("time", "t"), np.float32)
        return F.from_livox(xyz, intensity, line, time, pc2.stamp)
    if sensor == "rs_xyzi":  # rs_to_velodyne XYZI mode: synthesize ring+time
        ring = F.ring_from_elevation(xyz)
        time = F.synthesize_time_from_azimuth(xyz)
        return F.from_velodyne(xyz, intensity, ring, time, pc2.stamp)
    raise ValueError(f"unknown sensor {sensor!r}")


# ---------------------------------------------------------------------------
# encoders (round-trip tests + odometry-bag export, saveBagFlag parity)
# ---------------------------------------------------------------------------


def _enc_header(stamp: float, frame_id: str = "", seq: int = 0) -> bytes:
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    fid = frame_id.encode()
    return struct.pack("<III", seq, secs, nsecs) + struct.pack("<I", len(fid)) + fid


def encode_pointcloud2(xyz: np.ndarray, intensity: np.ndarray,
                       ring: np.ndarray, time: np.ndarray, stamp: float,
                       frame_id: str = "lidar") -> bytes:
    """Velodyne-layout XYZIRT cloud -> serialized sensor_msgs/PointCloud2."""
    n = len(xyz)
    dtype = np.dtype({"names": ["x", "y", "z", "intensity", "ring", "time"],
                      "formats": ["<f4", "<f4", "<f4", "<f4", "<u2", "<f4"],
                      "offsets": [0, 4, 8, 12, 16, 18], "itemsize": 22})
    arr = np.zeros(n, dtype)
    arr["x"], arr["y"], arr["z"] = (np.asarray(xyz[:, i], np.float32)
                                    for i in range(3))
    arr["intensity"] = np.asarray(intensity, np.float32)
    arr["ring"] = np.asarray(ring, np.uint16)
    arr["time"] = np.asarray(time, np.float32)
    out = [_enc_header(stamp, frame_id)]
    out.append(struct.pack("<II", 1, n))            # height, width
    fields = [("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("intensity", 12, 7),
              ("ring", 16, 4), ("time", 18, 7)]
    out.append(struct.pack("<I", len(fields)))
    for name, off, dt in fields:
        nb = name.encode()
        out.append(struct.pack("<I", len(nb)) + nb
                   + struct.pack("<IBI", off, dt, 1))
    data = arr.tobytes()
    out.append(struct.pack("<BII", 0, dtype.itemsize, dtype.itemsize * n))
    out.append(struct.pack("<I", len(data)) + data)
    out.append(struct.pack("<B", 1))                # is_dense
    return b"".join(out)


def encode_pointcloud2_robosense(xyz: np.ndarray, intensity: np.ndarray,
                                 ring: np.ndarray, timestamp_abs: np.ndarray,
                                 stamp: float,
                                 frame_id: str = "rslidar") -> bytes:
    """Robosense RsPointXYZIRT layout -> serialized PointCloud2: per-point
    ABSOLUTE epoch timestamps as float64 (`timestamp` field), the layout the
    reference normalizes in imageProjection.cpp:260-274.  Exercises the
    float64-field decode path and the epoch-rebase discipline end-to-end."""
    n = len(xyz)
    dtype = np.dtype({"names": ["x", "y", "z", "intensity", "ring",
                                "timestamp"],
                      "formats": ["<f4", "<f4", "<f4", "<f4", "<u2", "<f8"],
                      "offsets": [0, 4, 8, 12, 16, 18], "itemsize": 26})
    arr = np.zeros(n, dtype)
    arr["x"], arr["y"], arr["z"] = (np.asarray(xyz[:, i], np.float32)
                                    for i in range(3))
    arr["intensity"] = np.asarray(intensity, np.float32)
    arr["ring"] = np.asarray(ring, np.uint16)
    arr["timestamp"] = np.asarray(timestamp_abs, np.float64)
    out = [_enc_header(stamp, frame_id)]
    out.append(struct.pack("<II", 1, n))            # height, width
    fields = [("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("intensity", 12, 7),
              ("ring", 16, 4), ("timestamp", 18, 8)]
    out.append(struct.pack("<I", len(fields)))
    for name, off, dt in fields:
        nb = name.encode()
        out.append(struct.pack("<I", len(nb)) + nb
                   + struct.pack("<IBI", off, dt, 1))
    data = arr.tobytes()
    out.append(struct.pack("<BII", 0, dtype.itemsize, dtype.itemsize * n))
    out.append(struct.pack("<I", len(data)) + data)
    out.append(struct.pack("<B", 1))                # is_dense
    return b"".join(out)


def encode_imu(stamp: float, orientation, angular_velocity,
               linear_acceleration, frame_id: str = "imu") -> bytes:
    z9 = np.zeros(9, "<f8").tobytes()
    return (_enc_header(stamp, frame_id)
            + np.asarray(orientation, "<f8").tobytes() + z9
            + np.asarray(angular_velocity, "<f8").tobytes() + z9
            + np.asarray(linear_acceleration, "<f8").tobytes() + z9)


def encode_navsatfix(stamp: float, lat: float, lon: float, alt: float,
                     cov=None, status: int = 0,
                     frame_id: str = "gps") -> bytes:
    cov = np.zeros(9) if cov is None else np.asarray(cov, np.float64)
    return (_enc_header(stamp, frame_id)
            + struct.pack("<bH", status, 1)
            + struct.pack("<ddd", lat, lon, alt)
            + cov.astype("<f8").tobytes() + struct.pack("<B", 0))


def encode_odometry(stamp: float, position, orientation,
                    pose_covariance=None, linear=None, angular=None,
                    frame_id: str = "odom", child: str = "base_link") -> bytes:
    pc = (np.zeros(36) if pose_covariance is None
          else np.asarray(pose_covariance, np.float64))
    lin = np.zeros(3) if linear is None else np.asarray(linear, np.float64)
    ang = np.zeros(3) if angular is None else np.asarray(angular, np.float64)
    cb = child.encode()
    return (_enc_header(stamp, frame_id)
            + struct.pack("<I", len(cb)) + cb
            + np.asarray(position, "<f8").tobytes()
            + np.asarray(orientation, "<f8").tobytes()
            + pc.astype("<f8").tobytes()
            + lin.astype("<f8").tobytes() + ang.astype("<f8").tobytes()
            + np.zeros(36, "<f8").tobytes())


def encode_gps_with_heading(stamp: float, lat: float, lon: float, alt: float,
                            heading: float, pitch: float = 0.0,
                            roll: float = 0.0, mode: int = 4,
                            cov=None, status: int = 0) -> bytes:
    return (_enc_header(stamp, "gps")
            + encode_navsatfix(stamp, lat, lon, alt, cov, status)
            + struct.pack("<fffb", heading, pitch, roll, mode))


# ---------------------------------------------------------------------------
# writer (testing + save-to-bag parity with the reference's saveBagFlag)
# ---------------------------------------------------------------------------


def _header_bytes(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        item = k + b"=" + v
        out += struct.pack("<I", len(item)) + item
    return out


class BagWriter:
    """Minimal rosbag 2.0 writer (one chunk).  Used by the tests for
    round-trip coverage, by `io/synthetic_bag.py`, and by the Runner's
    `record_bag` for odometry-bag export (the reference's saveBagFlag path,
    mapOptmization.cpp:243-246)."""

    def __init__(self, path: str, compression: str = "none"):
        """compression: 'none' or 'bz2' (what `rosbag compress --bz2`
        produces — vehicle logs in the field commonly arrive bz2-chunked;
        the reader transparently decompresses either)."""
        if compression not in ("none", "bz2"):
            raise ValueError(f"unsupported compression {compression!r}")
        self.path = path
        self.compression = compression
        self._conns: Dict[str, int] = {}
        self._conn_records: List[bytes] = []
        self._msg_records: List[bytes] = []

    def _record(self, header: Dict[bytes, bytes], payload: bytes) -> bytes:
        h = _header_bytes(header)
        return (struct.pack("<I", len(h)) + h
                + struct.pack("<I", len(payload)) + payload)

    def write(self, topic: str, msg_type: str, raw: bytes, stamp: float):
        if topic not in self._conns:
            cid = len(self._conns)
            self._conns[topic] = cid
            sub = _header_bytes({b"topic": topic.encode(),
                                 b"type": msg_type.encode(),
                                 b"md5sum": b"*",
                                 b"message_definition": b""})
            self._conn_records.append(self._record(
                {b"op": bytes([_OP_CONNECTION]),
                 b"conn": struct.pack("<I", cid),
                 b"topic": topic.encode()}, sub))
        secs = int(stamp)
        nsecs = int(round((stamp - secs) * 1e9))
        self._msg_records.append(self._record(
            {b"op": bytes([_OP_MSG_DATA]),
             b"conn": struct.pack("<I", self._conns[topic]),
             b"time": struct.pack("<II", secs, nsecs)}, raw))

    def close(self):
        chunk = b"".join(self._conn_records + self._msg_records)
        with open(self.path, "wb") as f:
            f.write(_BAG_MAGIC)
            # bag header record padded to 4096 bytes like rosbag does
            hdr = {b"op": bytes([_OP_BAG_HEADER]),
                   b"index_pos": struct.pack("<Q", 0),
                   b"conn_count": struct.pack("<I", len(self._conns)),
                   b"chunk_count": struct.pack("<I", 1)}
            h = _header_bytes(hdr)
            pad = max(4096 - len(h) - 8, 0)
            f.write(struct.pack("<I", len(h)) + h
                    + struct.pack("<I", pad) + b" " * pad)
            payload = (bz2.compress(chunk) if self.compression == "bz2"
                       else chunk)
            f.write(self._record(
                {b"op": bytes([_OP_CHUNK]),
                 b"compression": self.compression.encode(),
                 b"size": struct.pack("<I", len(chunk))}, payload))
