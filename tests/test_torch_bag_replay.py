"""The port's bag entry point as a whole: `write_synthetic_bag` ->
`replay_bag` -> `Runner(device="cpu", record_bag=...)`.

- The non-slow cases of tests/test_bag_replay_e2e.py: epoch stamps are
  rebased on the host; NavSatFix covariances reach the GPS gate.
- The two writers: the same messages for the same arguments.  Headers,
  stamps, rings, point times, GPS records and every byte of the layout are
  equal; what passes through float32 rotations (points, IMU quaternions,
  accelerations) is within 1e-5 m and 1e-6 (measured: 7.6e-6 m, two float32
  ulps at 60 m; 5.8e-7 m/s^2).
- One 8-scan bag of 2048 points (the loop mission's circle at 10 Hz in a
  30 m world, with GPS and the raw GpswithHeading stream) and a hostile
  variant (bz2, the Robosense layout, duplicated and reordered IMU, an IMU
  dropout, GPS at 100 Hz), each written once by the port and replayed by
  both packages (the JAX feed with the port's repaired IMU window start,
  `torch_port_helpers.repaired_jax_feed`): the same scans and keyframe
  flags, poses within 1e-4 m / rad (measured: 8.9e-7 and 2.2e-6), and
  output bags whose odometry records agree to the same tolerance with the
  same stamps, degenerate flags and record counts.
- The CLI's `--bag ... --record-bag` on the CPU.
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.io import bag_replay as jbag_replay
from lio_slam_tpu.io import rosbag as jrb
from lio_slam_tpu.io import synthetic_bag as jsynthetic_bag
from lio_slam_tpu.pipeline.runner import Runner as JaxRunner
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch.io import formats, rosbag as rb, synthetic
from lio_slam_tpu_torch.io.bag_replay import BagTopics, replay_bag
from lio_slam_tpu_torch.io.synthetic_bag import write_synthetic_bag
from lio_slam_tpu_torch.pipeline.runner import Runner
from lio_slam_tpu_torch.utils import se3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH = 1.7e9
POSE_TOL = 1e-4


def bag_cfg(m, **kw):
    """tests/test_bag_replay_e2e.py's `bag_cfg` at 2048 points, loop
    closure off."""
    return m.Config(
        static=m.StaticConfig(max_raw_points=2048, max_scan_points=2048,
                              max_map_points=8192, max_keyframes=16,
                              max_keyframe_points=1024, max_loop_queue=2,
                              max_gps_queue=8, window_size=8,
                              max_imu_window=128),
        registration=m.RegistrationConfig(degeneracy_eig_thresh=10.0),
        loop=m.LoopClosureConfig(enabled=False), **kw)


def rebase_truth(poses):
    p0 = torch.from_numpy(poses[0])
    return np.stack([se3.pose6_between(p0, torch.from_numpy(p)).numpy()
                     for p in poses])


def test_epoch_stamps_rebased_in_runner():
    """Epoch-magnitude stamps leave only mission-relative times on the
    device: keyframe stamps stay small and the trajectory equals the same
    mission's at zero-based stamps."""
    seq = synthetic.make_sequence(n_scans=6, n_points=2048, seed=3)

    def run(offset):
        runner = Runner(H.small_config(port_config), device="cpu",
                        loop_every=100)
        for i in range(6):
            m = seq.scan_masks[i]
            runner.process_scan(formats.StandardScan(
                xyz=seq.scans[i][m],
                intensity=np.zeros(int(m.sum()), np.float32),
                ring=np.zeros(int(m.sum()), np.uint16),
                time=np.zeros(int(m.sum()), np.float32),
                stamp=float(seq.stamps[i]) + offset))
        return runner

    r_epoch, r_zero = run(EPOCH), run(0.0)
    n = int(r_epoch.state.store.count)
    stamps = r_epoch.state.store.stamps[:n].numpy()
    assert stamps.max() < 1e5, "device keyframe stamps must be mission-relative"
    np.testing.assert_allclose(np.stack(r_epoch.trajectory),
                               np.stack(r_zero.trajectory), atol=1e-5)


def test_bag_replay_gps_covariance_gating(tmp_path):
    """NavSatFix covariance flows bag -> intake -> factor gating: fixes with
    covariance 100 >> gpsCovThreshold are rejected (addGPSFactor
    :1984-1989), good fixes become factors."""
    path = str(tmp_path / "gps.bag")
    n = 10
    write_synthetic_bag(path, n_scans=n, n_points=2048, seed=1, epoch=EPOCH,
                        scan_period=1.0, yaw_rate=0.0, speed=2.0,
                        gps=True, gps_cov=0.25, gps_bad_cov_every=2)
    cfg = bag_cfg(port_config, gps=port_config.GpsConfig(
        use_gps=True, gps_cov_threshold=2.0, pose_cov_threshold=0.0,
        min_travel_before_gps=3.0, gps_distance_frequency=2.0))
    runner = Runner(cfg, device="cpu", loop_every=100)
    results = list(replay_bag(runner, path, BagTopics(gps="/gps/fix")))
    assert len(results) == n
    assert int(runner.state.gps_count) >= 2, \
        "good-covariance fixes must become GPS factors"
    g = runner.state.graph
    infos = g.gps_info[g.gps_mask].numpy()
    # variances are floored at 1.0 m^2 (addGPSFactor :2030): a good fix
    # (cov 0.25) lands at information 1.0; a bad one (cov 100) would show
    # 0.01 here only if the covariance gate leaked it
    assert np.all(infos[:, :2] >= 0.99)
    assert runner.gps_intake.datum is not None


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

# a 30 m world: 2048 points of the 60 m world leave the registration
# short of constraints (most scans run to the iteration cap)
SMALL_BAG = dict(n_scans=8, n_points=2048, seed=0, epoch=EPOCH,
                 scan_period=0.1, sweep_time=0.1, speed=2.0, yaw_rate=0.6,
                 world_extent=30.0, gps=True, gps_cov=0.25,
                 raw_gps_topic="/gpsdata")
HOSTILE = dict(SMALL_BAG, seed=5, yaw_rate=0.0, raw_gps_topic=None,
               gps_rate_hz=100.0, compression="bz2", sensor_layout="robosense",
               shuffle_window=0.005, dup_every=7, drop_imu_spans=((0.3, 0.45),))
VARIANTS = {
    "plain": (SMALL_BAG, {"gps": "/gps/fix", "raw_gps": "/gpsdata"}),
    "hostile": (HOSTILE, {"gps": "/gps/fix", "sensor": "robosense"}),
}
ROTATED = {"x": 1e-5, "y": 1e-5, "z": 1e-5}          # metres


def assert_messages_close(a, b):
    """Two decoded messages: equal, except the fields that pass through a
    float32 rotation, which agree within the stated tolerances."""
    if isinstance(a, rb.PointCloud2) or isinstance(a, jrb.PointCloud2):
        assert (a.stamp, a.frame_id, a.is_dense) == (b.stamp, b.frame_id, b.is_dense)
        assert a.points.dtype.names == b.points.dtype.names
        for f in a.points.dtype.names:
            if f in ROTATED:
                np.testing.assert_allclose(b.points[f], a.points[f], rtol=0,
                                           atol=ROTATED[f], err_msg=f)
            else:
                np.testing.assert_array_equal(b.points[f], a.points[f], f)
    elif hasattr(a, "linear_acceleration"):
        assert a.stamp == b.stamp
        for f in ("orientation", "angular_velocity", "linear_acceleration"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=0,
                                       atol=1e-6, err_msg=f)
    else:
        for k, v in vars(a).items():
            w = getattr(b, k)
            if hasattr(v, "__dataclass_fields__"):
                assert_messages_close(v, w)
            else:
                assert np.array_equal(v, w), k


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_both_writers_give_the_same_messages(tmp_path, variant):
    kw = dict(VARIANTS[variant][0], n_scans=5)
    pj, pt = str(tmp_path / "j.bag"), str(tmp_path / "t.bag")
    tj = jsynthetic_bag.write_synthetic_bag(pj, **kw)
    tt = write_synthetic_bag(pt, **kw)
    np.testing.assert_array_equal(tt.poses, tj.poses)
    np.testing.assert_array_equal(tt.stamps, tj.stamps)
    ma = list(jrb.BagReader(pj).read_messages())
    mb = list(rb.BagReader(pt).read_messages())
    assert [(m.topic, m.msg_type, m.stamp) for m in ma] == \
        [(m.topic, m.msg_type, m.stamp) for m in mb]
    assert collections.Counter(m.topic for m in mb)["/imu/data"] > 0
    for x, y in zip(ma, mb):
        assert len(x.raw) == len(y.raw)
        assert_messages_close(x.decode(), y.decode())


def replay_both(path, topics, record_dir):
    """The bag through both packages' replay_bag + Runner on the CPU, each
    recording its output bag; returns {package: (runner, results)}."""
    cfg = dict(gps=port_config.GpsConfig(use_gps=True, pose_cov_threshold=-1.0))
    out = {}
    for name, runner in (
            ("jax", JaxRunner(bag_cfg(jax_config, gps=jax_config.GpsConfig(
                **dataclasses.asdict(cfg["gps"]))), loop_every=100,
                record_bag=os.path.join(record_dir, "jax.bag"))),
            ("port", Runner(bag_cfg(port_config, **cfg), device="cpu",
                            loop_every=100,
                            record_bag=os.path.join(record_dir, "port.bag")))):
        replay = jbag_replay.replay_bag if name == "jax" else replay_bag
        tcls = jbag_replay.BagTopics if name == "jax" else BagTopics
        with H.repaired_jax_feed():
            results = list(replay(runner, path, tcls(**topics),
                                  use_native=None))
        runner.close()
        out[name] = (runner, results)
    return out


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def replayed(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(request.param)
    kw, topics = VARIANTS[request.param]
    path = str(d / "in.bag")
    truth = write_synthetic_bag(path, **kw)
    return truth, d, replay_both(path, topics, str(d))


def test_both_replays_agree(replayed):
    truth, _, out = replayed
    (jr, ja), (tr, tb) = out["jax"], out["port"]
    assert len(tb) == len(ja) == len(truth.stamps)
    assert [r.is_keyframe for r in tb] == [r.is_keyframe for r in ja]
    assert sum(r.is_keyframe for r in tb) >= 2
    dev = np.abs(np.stack([r.pose for r in tb]) - np.stack([r.pose for r in ja]))
    assert dev.max() < POSE_TOL, dev.max(axis=0)
    assert all(r.imu_rate_poses is not None for r in tb[1:])
    rel = rebase_truth(truth.poses)
    assert synthetic.ate_rmse(np.stack([r.pose for r in tb]), rel) < 0.05
    assert int(tr.state.gps_count) == int(jr.state.gps_count)
    assert tr.fsm.mode == jr.fsm.mode


def test_recorded_bags_hold_the_same_records(replayed):
    """Both output bags read back with both readers; one odometry record a
    scan at the scan's stamp, the degenerate flag in covariance[0], and the
    gpsdata / sensor_fusion_output records once the datum exists."""
    _, d, out = replayed
    bags = {}
    for name in ("jax", "port"):
        path = str(d / f"{name}.bag")
        msgs = list(rb.BagReader(path).read_messages())
        assert [m.raw for m in msgs] == \
            [m.raw for m in jrb.BagReader(path).read_messages()]
        bags[name] = msgs
    ja, tb = bags["jax"], bags["port"]
    assert [(m.topic, m.stamp) for m in tb] == [(m.topic, m.stamp) for m in ja]
    counts = collections.Counter(m.topic for m in tb)
    n = len(out["port"][1])
    assert counts["/liorf/mapping/odometry"] == n
    assert counts["/liorf/gpsdata"] == counts["/sensor_fusion_output"] >= n - 1
    odo = [(x.decode(), y.decode()) for x, y in zip(ja, tb)
           if x.topic == "/liorf/mapping/odometry"]
    traj = np.stack(out["port"][0].trajectory)
    for k, (a, b) in enumerate(odo):
        assert (b.stamp, b.frame_id, b.child_frame_id) == \
            (a.stamp, a.frame_id, a.child_frame_id)
        assert b.pose_covariance[0] == a.pose_covariance[0]
        np.testing.assert_allclose(b.position, a.position, atol=POSE_TOL)
        np.testing.assert_allclose(b.orientation, a.orientation, atol=POSE_TOL)
        np.testing.assert_allclose(b.position, traj[k, 3:], atol=1e-6)
    for x, y in zip(ja, tb):
        if x.topic != "/liorf/mapping/odometry":
            a, b = x.decode(), y.decode()
            assert (b.mode, b.stamp) == (a.mode, a.stamp)
            assert abs(b.gps.latitude - a.gps.latitude) < 1e-8
            assert abs(b.gps.longitude - a.gps.longitude) < 1e-8


@pytest.mark.parametrize("source", ["bag", "synthetic"])
def test_cli_replays_a_bag_and_records_outputs(tmp_path, source):
    """`python -m lio_slam_tpu_torch.pipeline.runner --bag X --device cpu
    --record-bag Y` prints the JAX CLI's summary keys and writes Y;
    `--record-bag` serves `--synthetic` too."""
    path, rec = str(tmp_path / "in.bag"), str(tmp_path / "out.bag")
    if source == "bag":
        write_synthetic_bag(path, **dict(SMALL_BAG, n_scans=3, n_points=512))
        args = ["--bag", path, "--gps-topic", "/gps/fix"]
        keys = {"bag", "final_pose"}
    else:
        args = ["--synthetic", "--scans", "3", "--points", "512"]
        keys = {"ate_rmse_m", "processed"}
    out = subprocess.run(
        [sys.executable, "-m", "lio_slam_tpu_torch.pipeline.runner", *args,
         "--device", "cpu", "--record-bag", rec, "--preset", "default"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.splitlines()[-1])
    assert set(summary) >= keys | {"scans", "elapsed_s", "scans_per_sec",
                                   "keyframes", "loops", "mapping_error",
                                   "recorded_bag"}
    assert summary["scans"] == 3 and summary["device"] == "cpu"
    assert summary["recorded_bag"] == rec
    topics = collections.Counter(m.topic for m in rb.BagReader(rec).read_messages())
    assert topics["/liorf/mapping/odometry"] == 3
