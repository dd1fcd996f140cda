"""The port's vendor adapters (`lio_slam_tpu_torch/io/formats.py`): the
format cases of tests/test_features_formats.py, and each adapter against
the JAX package's on the same seeded inputs (exactly: both are the same
numpy)."""

import numpy as np
import pytest

import torch_port_helpers as H  # noqa: F401  (single-threaded torch)
from lio_slam_tpu.io import formats as jformats
from lio_slam_tpu_torch.io import formats


class TestFormats:
    def test_velodyne_nan_removal(self):
        xyz = np.array([[1, 0, 0], [np.nan, 0, 0], [0, 1, 0]], np.float32)
        s = formats.from_velodyne(xyz, np.ones(3), np.zeros(3), np.zeros(3), 0.0)
        assert s.xyz.shape[0] == 2

    def test_ouster_time_conversion(self):
        xyz = np.ones((4, 3), np.float32)
        t_ns = np.array([0, 25_000_000, 50_000_000, 99_000_000])
        s = formats.from_ouster(xyz, np.ones(4), np.zeros(4), t_ns, 10.0)
        np.testing.assert_allclose(s.time, [0, 0.025, 0.05, 0.099], atol=1e-6)

    def test_robosense_relative_time(self):
        xyz = np.ones((3, 3), np.float32)
        ts = np.array([1700000000.00, 1700000000.05, 1700000000.10])
        s = formats.from_robosense(xyz, np.ones(3), np.zeros(3), ts, 0.0)
        np.testing.assert_allclose(s.time, [0, 0.05, 0.10], atol=1e-6)
        assert s.stamp == 1700000000.00

    def test_rs16_remap(self):
        assert formats.remap_ring_rs16([0, 1, 15]).tolist() == [0, 2, 1]

    def test_rs128_remap_is_permutation(self):
        out = formats.remap_ring_rs128(np.arange(128))
        assert sorted(out.tolist()) == list(range(128))

    def test_ring_from_elevation(self):
        # point at +15 deg elevation -> top ring; -15 deg -> ring 0
        up = np.array([[1.0, 0, np.tan(np.deg2rad(15.0))]])
        dn = np.array([[1.0, 0, np.tan(np.deg2rad(-15.0))]])
        assert formats.ring_from_elevation(up)[0] == 15
        assert formats.ring_from_elevation(dn)[0] == 0

    def test_time_from_azimuth_monotone_in_angle(self):
        ang = np.linspace(-np.pi + 0.01, np.pi - 0.01, 50)
        xyz = np.stack([np.cos(ang), np.sin(ang), np.zeros(50)], 1)
        t = formats.synthesize_time_from_azimuth(xyz, 0.1)
        assert (np.diff(t) > 0).all()
        assert 0 <= t.min() and t.max() <= 0.1


def vendor_inputs(key, seed=0, n=500):
    """Seeded raw arrays in `key`'s layout, a few points non-finite."""
    rs = np.random.RandomState(seed)
    xyz = rs.uniform(-40, 40, (n, 3)).astype(np.float32)
    xyz[rs.choice(n, 7, replace=False), rs.randint(0, 3, 7)] = np.nan
    intensity = rs.uniform(0, 255, n).astype(np.float32)
    ring = rs.randint(0, 16, n).astype(np.uint16)
    rel = np.sort(rs.uniform(0, 0.1, n))
    t = {"velodyne": rel.astype(np.float32), "livox": rel.astype(np.float32),
         "ouster": (rel * 1e9).astype(np.int64),
         "robosense": 1.7e9 + 0.123456 + rel,
         "mulran": (1.7e9 + rel) * 1e6}[key]
    return xyz, intensity, ring, t, 1.7e9 + 0.1


@pytest.mark.parametrize("key", sorted(formats.ADAPTERS))
def test_adapter_matches_jax(key):
    assert sorted(formats.ADAPTERS) == sorted(jformats.ADAPTERS)
    args = vendor_inputs(key)
    a, b = jformats.ADAPTERS[key](*args), formats.ADAPTERS[key](*args)
    assert b.xyz.shape == (len(args[0]) - 7, 3)
    for f in ("xyz", "intensity", "ring", "time"):
        assert getattr(b, f).dtype == getattr(a, f).dtype, f
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    assert b.stamp == a.stamp
    if key in ("robosense", "mulran"):
        # rebased in float64: sub-ms point times survive the epoch offset
        assert 0 <= b.time.min() and b.time.max() <= 0.1
        assert len(np.unique(b.time)) > len(b.time) // 2


def test_remaps_and_synthesis_match_jax():
    rs = np.random.RandomState(1)
    xyz = rs.uniform(-30, 30, (400, 3))
    np.testing.assert_array_equal(formats.RS16_REMAP, jformats.RS16_REMAP)
    np.testing.assert_array_equal(formats.RS128_REMAP, jformats.RS128_REMAP)
    np.testing.assert_array_equal(formats.ring_from_elevation(xyz),
                                  jformats.ring_from_elevation(xyz))
    np.testing.assert_array_equal(formats.synthesize_time_from_azimuth(xyz),
                                  jformats.synthesize_time_from_azimuth(xyz))
