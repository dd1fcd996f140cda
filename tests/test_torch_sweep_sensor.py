"""The port's spinning-scanner generator (`io/synthetic.py`) against the
JAX package's: `rig_sensor_for`, `make_sweep_trajectory`,
`make_sweep_sequence` (with outliers and scatter) and `make_imu_windows`,
and the two fast cases of tests/test_sweep_sensor.py on the port's copy.

Tolerances: rings, masks, trajectory, world and IMU attitudes exact;
points within 4 float32 ulps of their largest coordinate and point times
within 2 ulps; IMU windows within 1e-6.  The rotations are float32 in both
packages, and XLA's float32 sine and cosine differ from torch's by an ulp
on about one argument in twenty: the sweep's start rotation then differs
in its last bit, and so does a point's azimuth, its time and its time bin.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import torch_port_helpers as H  # noqa: F401  (single-threaded torch)
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.io import synthetic as jsyn
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch.io import synthetic as tsyn
from lio_slam_tpu_torch.utils import se3


def ulps(a, b, scale):
    return np.abs(a - b) / np.spacing(np.abs(scale).astype(np.float32))


@pytest.mark.parametrize("kw", [dict(n_scans=5, n_points=2048),
                                dict(n_scans=4, n_points=4096, speed=1.0,
                                     yaw_rate=1.2, outlier_frac=0.02,
                                     n_scatter=500)])
def test_sweep_sequence_matches_jax(kw):
    sj = jsyn.make_sweep_sequence(seed=0, sensor=jsyn.RigSensor(n_scan=16), **kw)
    sp = tsyn.make_sweep_sequence(seed=0, sensor=tsyn.RigSensor(n_scan=16), **kw)
    for k in ("rings", "scan_masks", "poses", "stamps", "imu_rpy", "world"):
        np.testing.assert_array_equal(getattr(sp, k), getattr(sj, k), err_msg=k)
    m = sj.scan_masks
    assert m.sum(1).min() > 1000
    big = np.abs(sj.scans).max(-1, keepdims=True)
    assert ulps(sp.scans, sj.scans, big)[m].max() <= 4
    assert ulps(sp.ptimes, sj.ptimes, sj.ptimes)[m].max() <= 2
    wj = jsyn.make_imu_windows(sj, 32, samples_per_scan=10, sweep_cover=0.1)
    wp = tsyn.make_imu_windows(sp, 32, samples_per_scan=10, sweep_cover=0.1)
    for a, b in zip(wp, wj):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_rig_sensor_and_trajectory_match_jax():
    for name in ("default", "kitti", "6t"):
        if name not in port_config.PRESETS:
            continue
        cp, cj = port_config.get_config(name), jax_config.get_config(name)
        assert tuple(tsyn.rig_sensor_for(cp)) == tuple(jsyn.rig_sensor_for(cj))
    for a, b in zip(tsyn.make_sweep_trajectory(30, yaw_rate=0.4),
                    jsyn.make_sweep_trajectory(30, yaw_rate=0.4)):
        np.testing.assert_array_equal(a, b)


def test_observe_sweep_static_platform_matches_world():
    """With the platform at rest a sweep is a beam-quantized static scan:
    body points re-project onto world points."""
    sensor = tsyn.RigSensor(n_scan=32, max_range=50.0)
    world = tsyn.make_world(seed=0, extent=30.0, n_per_surface=20000)
    poses = np.zeros((3, 6), np.float32)
    poses[:, 5] = 1.0
    stamps = np.arange(3, dtype=np.float32) * 0.1
    xyz, pt, ring, mask = tsyn.observe_sweep(world, poses, stamps, 1, 4096,
                                             sensor, noise=0.0,
                                             rng=np.random.RandomState(0))
    assert mask.sum() > 1000
    d, _ = cKDTree(world).query(xyz[mask] + np.array([0, 0, 1.0], np.float32))
    assert float(np.max(d)) < 1e-3
    assert 0.0 <= pt[mask].min() and pt[mask].max() <= sensor.sweep_time
    assert pt[mask].max() > 0.8 * sensor.sweep_time
    assert ring[mask].min() >= 0 and ring[mask].max() < sensor.n_scan
    assert len(np.unique(ring[mask])) > 8


def test_observe_sweep_motion_distorts_raw_cloud():
    """A yawing platform gives a distorted raw sweep: late points, put in
    the world with the sweep-start pose, miss the world (what deskew
    removes)."""
    sensor = tsyn.RigSensor(n_scan=32, max_range=50.0)
    seq = tsyn.make_sweep_sequence(n_scans=8, n_points=4096, seed=0,
                                   sensor=sensor, speed=1.0, yaw_rate=1.2,
                                   noise=0.0)
    i = 6
    m = seq.scan_masks[i]
    R0, t0 = se3.pose6_to_Rt(torch.from_numpy(seq.poses[i]))
    w = se3.transform_points(R0, t0, torch.from_numpy(seq.scans[i][m])).numpy()
    d, _ = cKDTree(seq.world).query(w, k=1)
    assert float(np.median(d[seq.ptimes[i][m] > 0.06])) > 0.3
