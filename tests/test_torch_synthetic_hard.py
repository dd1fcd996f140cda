"""The hard worlds of the port's generator against the JAX package's, and
the small leftovers of the port (`lio.empty_scan_input`,
`pointcloud.make_cloud / merge_clouds / random_downsample`,
`deskew.DeskewInfo / make_deskew_info`, `factors.cauchy_weight`) against
their JAX counterparts.

`make_corridor_world` draws in the JAX `RandomState` order: bit-equal.
`make_sequence` with each hard knob consumes the same draws (masks, the
outlier rows, the noisy attitude drawn last and the world with its clutter
are bit-equal); the observed points pass through a float32 rotation, so
they agree with JAX's to the ulps the clean case shows (measured over
seeds 0-3: at most 7.6e-6 m, two float32 ulps at 32-64 m, on about 14 % of
the coordinates, with and without the knobs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H  # noqa: F401  (single-threaded torch)
from torch_port_helpers import n, t
from lio_slam_tpu.graph import factors as jF
from lio_slam_tpu.io import synthetic as jsyn
from lio_slam_tpu.ops import deskew as jdk
from lio_slam_tpu.pipeline import lio as jlio
from lio_slam_tpu.utils import pointcloud as jpc
from lio_slam_tpu_torch.graph import factors as tF
from lio_slam_tpu_torch.io import synthetic as tsyn
from lio_slam_tpu_torch.ops import deskew as tdk
from lio_slam_tpu_torch.pipeline import lio as tlio
from lio_slam_tpu_torch.utils import pointcloud as tpc

# two float32 ulps at 32-64 m: the clean generator's largest difference
POINT_ATOL = 7.7e-6


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=3, length=40.0,
                                                   width=4.0, n_points=8000)])
def test_corridor_world_is_bit_equal(kw):
    np.testing.assert_array_equal(tsyn.make_corridor_world(**kw),
                                  jsyn.make_corridor_world(**kw))


KNOBS = {
    "clean": {},
    "outlier_frac": dict(outlier_frac=0.05),
    "range_noise": dict(range_noise=0.2),
    "n_scatter": dict(n_scatter=3000),
    "moving_object": dict(moving_object=True),
    "all four": dict(outlier_frac=0.02, range_noise=0.1, n_scatter=2000,
                     moving_object=True),
}


@pytest.mark.parametrize("name", list(KNOBS))
def test_make_sequence_hard_knobs_match_jax(name):
    kw = dict(n_scans=4, n_points=1024, seed=3, extent=40.0, **KNOBS[name])
    a = jsyn.make_sequence(**kw)
    b = tsyn.make_sequence(**kw)
    np.testing.assert_array_equal(b.world, a.world)
    np.testing.assert_array_equal(b.scan_masks, a.scan_masks)
    np.testing.assert_array_equal(b.poses, a.poses)
    np.testing.assert_array_equal(b.imu_rpy, a.imu_rpy)
    np.testing.assert_allclose(b.scans, a.scans, rtol=0, atol=POINT_ATOL)
    if "outlier_frac" in kw:
        # the garbage rows are drawn, not rotated: exactly JAX's.  With one
        # scan the mission without outliers draws the same up to them, so
        # the rows that differ from it are the garbage rows
        one = dict(kw, n_scans=1)
        clean = tsyn.make_sequence(**dict(one, outlier_frac=0.0))
        nv = int(b.scan_masks[0].sum())
        moved = np.any(b.scans[0, :nv] != clean.scans[0, :nv], axis=1)
        assert moved.sum() == int(nv * kw["outlier_frac"])
        np.testing.assert_array_equal(b.scans[0, :nv][moved],
                                      a.scans[0, :nv][moved])


def test_moving_object_crosses_the_scene():
    """The box's points are in the scans: the mission with the moving
    object differs from the static one near the box's path, as JAX's."""
    kw = dict(n_scans=6, n_points=2048, seed=1)
    a = jsyn.make_sequence(moving_object=True, **kw)
    b = tsyn.make_sequence(moving_object=True, **kw)
    still = tsyn.make_sequence(**kw)
    np.testing.assert_allclose(b.scans, a.scans, rtol=0, atol=POINT_ATOL)
    assert not np.array_equal(b.scans, still.scans)


def test_empty_scan_input():
    a = jlio.empty_scan_input(64)
    b = tlio.empty_scan_input(64, device="cpu")
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name == "cloud":
            for u, v in zip((x.xyz, x.mask), (y.xyz, y.mask)):
                np.testing.assert_array_equal(n(v), np.asarray(u))
            assert y.xyz.dtype == torch.float32 and y.mask.dtype == torch.bool
        elif x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(n(y), np.asarray(x))
            assert n(y).dtype == np.asarray(x).dtype


def test_make_and_merge_clouds():
    rs = np.random.RandomState(0)
    xa = rs.randn(40, 3).astype(np.float64)
    ma = rs.rand(40) > 0.3
    xb = rs.randn(25, 3).astype(np.float32)
    mb = rs.rand(25) > 0.5
    ja, jb = jpc.make_cloud(xa, ma), jpc.make_cloud(xb)
    ta, tb = tpc.make_cloud(xa, ma), tpc.make_cloud(xb)
    assert ta.xyz.dtype == torch.float32
    np.testing.assert_array_equal(n(ta.xyz), np.asarray(ja.xyz))
    np.testing.assert_array_equal(n(tb.mask), np.asarray(jb.mask))
    for cap in (30, 50, 80):
        jm = jpc.merge_clouds(jpc.make_cloud(xa, ma), jpc.make_cloud(xb, mb), cap)
        tm = tpc.merge_clouds(tpc.make_cloud(xa, ma), tpc.make_cloud(xb, mb), cap)
        np.testing.assert_array_equal(n(tm.mask), np.asarray(jm.mask))
        k = np.asarray(jm.mask)
        np.testing.assert_array_equal(n(tm.xyz)[k], np.asarray(jm.xyz)[k])


@pytest.mark.parametrize("n_valid,max_out", [(300, 64), (64, 64), (10, 64),
                                             (0, 16), (257, 100)])
def test_random_downsample(n_valid, max_out):
    """By its contract (max_out slots, valid points taken from the cloud's
    valid points) and bit for bit against JAX's, whose subsample is a
    deterministic stride that never reads its key."""
    rs = np.random.RandomState(n_valid)
    xyz = rs.randn(400, 3).astype(np.float32)
    mask = np.zeros(400, bool)
    mask[rs.permutation(400)[:n_valid]] = True
    cloud = tpc.Cloud(xyz=t(xyz), mask=t(mask))
    out = tpc.random_downsample(cloud, max_out)
    assert out.xyz.shape == (max_out, 3)
    got = n(out.xyz)[n(out.mask)]
    assert len(got) == min(n_valid, max_out) or (n_valid > max_out
                                                 and 0 < len(got) <= max_out)
    valid = {tuple(p) for p in xyz[mask]}
    assert all(tuple(p) in valid for p in got)
    ref = jpc.random_downsample(jpc.Cloud(xyz=jnp.asarray(xyz),
                                          mask=jnp.asarray(mask)), max_out)
    np.testing.assert_array_equal(n(out.mask), np.asarray(ref.mask))
    np.testing.assert_array_equal(got, np.asarray(ref.xyz)[np.asarray(ref.mask)])


def test_deskew_info_and_cauchy_weight():
    args = (True, 0, [0.1, -0.2, 0.3], np.arange(6, dtype=np.float64))
    a = jdk.make_deskew_info(*args)
    b = tdk.make_deskew_info(*args)
    assert b._fields == a._fields
    for x, y in zip(a, b):
        np.testing.assert_array_equal(n(y), np.asarray(x))
        assert n(y).dtype == np.asarray(x).dtype
    e = np.array([0.0, 0.01, 0.25, 1.0, 100.0], np.float32)
    for k in (0.5, 1.0):
        np.testing.assert_allclose(n(tF.cauchy_weight(t(e), k)),
                                   np.asarray(jF.cauchy_weight(jnp.asarray(e), k)),
                                   rtol=1e-7)
