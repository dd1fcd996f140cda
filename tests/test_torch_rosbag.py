"""The port's ROS1 bag reader / writer and message codecs
(`lio_slam_tpu_torch/io/rosbag.py`): the cases of tests/test_rosbag.py, and
against the JAX package's copy: the same bytes from every encoder, each
package's reader on the other's bag (none and bz2), and
`scan_from_pointcloud2` for all six sensor keys.  Both are the same numpy,
so every comparison is exact."""

import bz2
import struct

import numpy as np
import pytest

import torch_port_helpers as H
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.io import rosbag as jrb
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch.io import rosbag as rb
from lio_slam_tpu_torch.io.bag_replay import BagTopics, replay_bag
from lio_slam_tpu_torch.pipeline.runner import Runner


def _write_sample_bag(path, n_scans=3, imu_per_scan=10, with_gps=True,
                      mod=rb, compression="none"):
    w = mod.BagWriter(str(path), compression=compression)
    t0 = 100.0
    rng = np.random.default_rng(0)
    for i in range(n_scans):
        ts = t0 + 0.1 * i
        for j in range(imu_per_scan):
            it = ts + 0.01 * j
            w.write("/imu/data", "sensor_msgs/Imu",
                    mod.encode_imu(it, [0, 0, 0, 1], [0.0, 0.0, 0.1],
                                   [0.0, 0.0, 9.81]), it)
        n = 64
        xyz = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
        w.write("/velodyne_points", "sensor_msgs/PointCloud2",
                mod.encode_pointcloud2(
                    xyz, np.full(n, 7.0, np.float32),
                    np.arange(n, dtype=np.uint16) % 16,
                    np.linspace(0, 0.09, n).astype(np.float32), ts), ts)
        if with_gps:
            w.write("/gps/fix", "sensor_msgs/NavSatFix",
                    mod.encode_navsatfix(ts, 39.9 + i * 1e-5, 116.3, 50.0,
                                         cov=np.eye(3).ravel()), ts)
    w.close()
    return str(path)


def test_bag_roundtrip_pointcloud(tmp_path):
    path = _write_sample_bag(tmp_path / "a.bag")
    reader = rb.BagReader(path)
    scans = [m for m in reader.read_messages(["/velodyne_points"])]
    assert len(scans) == 3
    assert scans[0].msg_type == "sensor_msgs/PointCloud2"
    pc2 = scans[0].decode()
    assert pc2.points.shape == (64,)
    assert set(pc2.points.dtype.names) >= {"x", "y", "z", "intensity",
                                           "ring", "time"}
    xyz = pc2.xyz()
    assert xyz.shape == (64, 3) and np.isfinite(xyz).all()
    assert abs(pc2.stamp - 100.0) < 1e-6
    std = rb.scan_from_pointcloud2(pc2, "velodyne")
    assert std.xyz.shape == (64, 3)
    assert std.ring.dtype == np.uint16
    np.testing.assert_allclose(std.time[-1], 0.09, atol=1e-6)


def test_bag_roundtrip_imu_gps_odom(tmp_path):
    path = _write_sample_bag(tmp_path / "b.bag")
    reader = rb.BagReader(path)
    msgs = list(reader.read_messages(["/imu/data", "/gps/fix"]))
    imus = [m.decode() for m in msgs if m.topic == "/imu/data"]
    fixes = [m.decode() for m in msgs if m.topic == "/gps/fix"]
    assert len(imus) == 30 and len(fixes) == 3
    np.testing.assert_allclose(imus[0].linear_acceleration, [0, 0, 9.81])
    np.testing.assert_allclose(imus[0].angular_velocity, [0, 0, 0.1])
    assert abs(fixes[1].latitude - 39.90001) < 1e-9
    assert fixes[0].position_covariance[0] == 1.0

    raw = rb.encode_odometry(5.0, [1, 2, 3], [0, 0, 0, 1],
                             pose_covariance=np.arange(36.0))
    od = rb.decode_odometry(raw)
    np.testing.assert_allclose(od.position, [1, 2, 3])
    assert od.pose_covariance[35] == 35.0
    assert od.child_frame_id == "base_link"

    raw = rb.encode_gps_with_heading(6.0, 40.0, 117.0, 30.0, heading=92.5,
                                     pitch=1.0, roll=-0.5, mode=4)
    g = rb.decode_gps_with_heading(raw)
    assert abs(g.gps.latitude - 40.0) < 1e-12
    assert abs(g.heading - 92.5) < 1e-5
    assert g.mode == 4


def test_bag_bz2_chunk(tmp_path):
    """bz2-compressed chunks decompress transparently."""
    path = _write_sample_bag(tmp_path / "c.bag", n_scans=1, with_gps=False)
    data = open(path, "rb").read()
    plain = list(rb.BagReader(path).read_messages())
    out = [rb._BAG_MAGIC]
    for header, payload in rb._records(data, len(rb._BAG_MAGIC)):
        op = header.get(b"op", b"\x00")[0]
        if op == rb._OP_CHUNK:
            comp = bz2.compress(payload)
            h = rb._header_bytes({b"op": bytes([rb._OP_CHUNK]),
                                  b"compression": b"bz2",
                                  b"size": struct.pack("<I", len(payload))})
            out.append(struct.pack("<I", len(h)) + h
                       + struct.pack("<I", len(comp)) + comp)
        else:
            h = rb._header_bytes(header)
            out.append(struct.pack("<I", len(h)) + h
                       + struct.pack("<I", len(payload)) + payload)
    p2 = tmp_path / "c_bz2.bag"
    p2.write_bytes(b"".join(out))
    got = list(rb.BagReader(str(p2)).read_messages())
    assert len(got) == len(plain)
    assert got[0].raw == plain[0].raw


def test_bad_magic(tmp_path):
    p = tmp_path / "x.bag"
    p.write_bytes(b"not a bag")
    with pytest.raises(ValueError, match="not a ROS bag"):
        list(rb.BagReader(str(p)).read_messages())


def test_replay_bag_through_runner(tmp_path):
    path = _write_sample_bag(tmp_path / "d.bag", n_scans=3)
    runner = Runner(H.small_config(port_config), device="cpu", loop_every=100)
    topics = BagTopics(lidar="/velodyne_points", imu="/imu/data",
                       gps="/gps/fix", sensor="velodyne")
    results = list(replay_bag(runner, path, topics))
    assert len(results) >= 1
    for r in results:
        assert np.isfinite(r.pose).all()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _messages(rs):
    """One seeded message of each encoder: name -> (args, kwargs)."""
    n = 97
    xyz = rs.uniform(-50, 50, (n, 3)).astype(np.float32)
    inten = rs.uniform(0, 255, n).astype(np.float32)
    ring = rs.randint(0, 16, n).astype(np.uint16)
    # stamps whose fraction rounds at the nanosecond: the header's rounding
    stamp = 1.7e9 + 0.1234567894
    return {
        "pointcloud2": ((xyz, inten, ring,
                         np.sort(rs.uniform(0, 0.1, n)).astype(np.float32),
                         stamp), {}),
        "pointcloud2_robosense": ((xyz, inten, ring,
                                   stamp + np.sort(rs.uniform(0, 0.1, n)),
                                   stamp), {}),
        "imu": ((stamp, rs.randn(4), rs.randn(3), rs.randn(3)), {}),
        "navsatfix": ((stamp, 31.0 + rs.rand(), 121.0 + rs.rand(),
                       10.0 * rs.rand()), {"cov": rs.rand(9), "status": 2}),
        "odometry": ((stamp, rs.randn(3), rs.randn(4)),
                     {"pose_covariance": rs.randn(36), "linear": rs.randn(3),
                      "angular": rs.randn(3)}),
        "gps_with_heading": ((stamp, 31.0 + rs.rand(), 121.0 + rs.rand(),
                              10.0 * rs.rand(), 360.0 * rs.rand(), 0.3, -0.2),
                             {"mode": 4, "cov": rs.rand(9)}),
    }


@pytest.mark.parametrize("name", sorted(_messages(np.random.RandomState(0))))
def test_encoder_gives_jax_bytes_and_decodes_alike(name):
    args, kw = _messages(np.random.RandomState(3))[name]
    raw = getattr(rb, "encode_" + name)(*args, **kw)
    assert raw == getattr(jrb, "encode_" + name)(*args, **kw)
    msg_type = {"pointcloud2": "sensor_msgs/PointCloud2",
                "pointcloud2_robosense": "sensor_msgs/PointCloud2",
                "imu": "sensor_msgs/Imu", "navsatfix": "sensor_msgs/NavSatFix",
                "odometry": "nav_msgs/Odometry",
                "gps_with_heading": "sensor_driver_msgs/GpswithHeading"}[name]
    a, b = jrb.decode_message(msg_type, raw), rb.decode_message(msg_type, raw)
    assert_same_message(a, b)


def assert_same_message(a, b):
    """Field for field (recursing into an embedded NavSatFix)."""
    assert type(a).__name__ == type(b).__name__
    for k, v in vars(a).items():
        w = getattr(b, k)
        if hasattr(v, "__dataclass_fields__"):
            assert_same_message(v, w)
        elif isinstance(v, np.ndarray):
            assert v.dtype == w.dtype and v.tobytes() == w.tobytes(), k
        else:
            assert v == w, k


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_each_reader_reads_the_other_packages_bag(tmp_path, compression):
    paths = {m.__name__: _write_sample_bag(tmp_path / f"{i}.bag", mod=m,
                                           compression=compression)
             for i, m in enumerate((jrb, rb))}
    a, b = (open(p, "rb").read() for p in paths.values())
    assert a == b
    for writer in paths.values():
        jr, tr = jrb.BagReader(writer), rb.BagReader(writer)
        ja, tb = list(jr.read_messages()), list(tr.read_messages())
        assert len(ja) == len(tb) == 36
        for x, y in zip(ja, tb):
            assert (x.topic, x.msg_type, x.stamp, x.raw) == \
                (y.topic, y.msg_type, y.stamp, y.raw)
            assert_same_message(x.decode(), y.decode())
        assert {k: vars(c) for k, c in tr.connections.items()} == \
            {k: vars(c) for k, c in jr.connections.items()}
        assert len(list(tr.read_messages(["/gps/fix"]))) == 3


def _cloud_for(sensor, rs, n=300):
    """A PointCloud2 in the layout `sensor` reads, a few points NaN."""
    xyz = rs.uniform(-30, 30, (n, 3)).astype(np.float32)
    xyz[::37, 1] = np.nan
    rel = np.sort(rs.uniform(0, 0.1, n))
    fields = [("x", "<f4", xyz[:, 0]), ("y", "<f4", xyz[:, 1]),
              ("z", "<f4", xyz[:, 2]),
              ("intensity", "<f4", rs.uniform(0, 100, n))]
    ring = rs.randint(0, 16, n)
    fields += {
        "velodyne": [("ring", "<u2", ring), ("time", "<f4", rel)],
        "ouster": [("t", "<u4", rel * 1e9), ("ring", "<u2", ring)],
        "robosense": [("ring", "<u2", ring), ("timestamp", "<f8", 1.7e9 + rel)],
        "mulran": [("t", "<f8", (1.7e9 + rel) * 1e6), ("ring", "<u2", ring)],
        "livox": [("line", "<u1", ring % 6), ("time", "<f4", rel)],
        "rs_xyzi": [],
    }[sensor]
    dtype = np.dtype([(f, t) for f, t, _ in fields])
    arr = np.zeros(n, dtype)
    for f, _, v in fields:
        arr[f] = v
    return rb.PointCloud2(stamp=1.7e9 + 0.05, frame_id="lidar", points=arr,
                          is_dense=False)


@pytest.mark.parametrize("sensor", ["velodyne", "ouster", "robosense", "mulran",
                                    "livox", "rs_xyzi"])
def test_scan_from_pointcloud2_matches_jax(sensor):
    pc2 = _cloud_for(sensor, np.random.RandomState(4))
    a = jrb.scan_from_pointcloud2(pc2, sensor)
    b = rb.scan_from_pointcloud2(pc2, sensor)
    assert len(b.xyz) == 300 - len(range(0, 300, 37))
    for f in ("xyz", "intensity", "ring", "time"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert a.stamp == b.stamp
    with pytest.raises(ValueError, match="unknown sensor"):
        rb.scan_from_pointcloud2(pc2, "hdl")
