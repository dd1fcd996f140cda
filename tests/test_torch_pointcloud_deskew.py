"""utils/pointcloud and ops/deskew of the port against the JAX package.

Masks must be equal exactly (the voxel ids and the stable sorts are
bit-identical); centroids agree within 1e-5 m (segment sums in float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import n, t
from lio_slam_tpu.ops import deskew as jdk
from lio_slam_tpu.utils import pointcloud as jpc
from lio_slam_tpu_torch.ops import deskew as tdk
from lio_slam_tpu_torch.utils import pointcloud as tpc


def cloud_arrays(seed=0, N=1536):
    rs = np.random.RandomState(seed)
    xyz = np.concatenate([rs.uniform(-30, 30, (N // 2, 3)),
                          rs.uniform(-2, 2, (N // 4, 3)),            # dense blob
                          np.round(rs.uniform(-5, 5, (N // 4, 3)) / 0.4) * 0.4  # on voxel edges
                          ]).astype(np.float32)
    mask = rs.uniform(size=N) > 0.1
    ring = rs.randint(0, 16, N).astype(np.int32)
    return xyz, mask, ring


def both(xyz, mask):
    return (jpc.Cloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask)),
            tpc.Cloud(xyz=t(xyz), mask=t(mask)))


def assert_cloud_close(a, b, atol=1e-5):
    np.testing.assert_array_equal(n(a.mask), n(b.mask))
    m = n(a.mask)
    np.testing.assert_allclose(n(b.xyz)[m], n(a.xyz)[m], atol=atol)


def test_filter_and_decimate():
    xyz, mask, ring = cloud_arrays()
    ca, cb = both(xyz, mask)
    fa = jpc.filter_points(ca, 1.5, 40.0, (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    fb = tpc.filter_points(cb, 1.5, 40.0, (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    np.testing.assert_array_equal(n(fa.mask), n(fb.mask))
    da = jpc.decimate(fa, 3, ring=jnp.asarray(ring), downsample_rate=2)
    db = tpc.decimate(fb, 3, ring=t(ring), downsample_rate=2)
    np.testing.assert_array_equal(n(da.mask), n(db.mask))
    assert int(db.count()) == int(da.count())


def test_compact():
    xyz, mask, _ = cloud_arrays(1)
    ca, cb = both(xyz, mask)
    a, b = jpc.compact(ca), tpc.compact(cb)
    np.testing.assert_array_equal(n(a.mask), n(b.mask))
    np.testing.assert_array_equal(n(a.xyz), n(b.xyz))


@pytest.mark.parametrize("leaf,max_out", [(0.4, 1024), (1.0, 256), (0.4, 64)])
def test_voxel_downsample(leaf, max_out):
    xyz, mask, _ = cloud_arrays(2)
    ca, cb = both(xyz, mask)
    assert_cloud_close(jpc.voxel_downsample(ca, leaf, max_out),
                       tpc.voxel_downsample(cb, leaf, max_out))


@pytest.mark.parametrize("leaf,max_out", [(0.4, 2048), (0.4, 300), (0.25, 1024)])
def test_packed_voxel_downsample(leaf, max_out):
    xyz, mask, _ = cloud_arrays(3)
    ca, cb = both(xyz, mask)
    a = jpc.packed_voxel_downsample(ca, leaf, max_out)
    b = tpc.packed_voxel_downsample(cb, leaf, max_out)
    assert_cloud_close(a, b)
    assert int(n(b.mask).sum()) > 10


@pytest.mark.parametrize("fn", ["voxel_downsample", "packed_voxel_downsample"])
def test_downsample_output_is_contiguous(fn):
    """The kernel's wrapper takes the downsampled scan as it comes and
    refuses a strided one."""
    xyz, mask, _ = cloud_arrays(4)
    out = getattr(tpc, fn)(tpc.Cloud(xyz=t(xyz), mask=t(mask)), 0.4, 512)
    assert out.xyz.is_contiguous() and out.mask.is_contiguous()
    assert out.xyz.shape == (512, 3)


def imu_table_inputs(seed=0, T=32, n_valid=24):
    rs = np.random.RandomState(seed)
    gyr = (rs.randn(T, 3) * 0.3).astype(np.float32)
    times = (np.arange(T) * 0.005 - 0.05).astype(np.float32)
    mask = np.arange(T) < n_valid
    return gyr, times, mask


def test_rotation_table_and_interpolation():
    gyr, times, mask = imu_table_inputs()
    ta = jdk.build_rotation_table(jnp.asarray(gyr), jnp.asarray(times),
                                  jnp.asarray(mask))
    tb = tdk.build_rotation_table(t(gyr), t(times), t(mask))
    np.testing.assert_allclose(n(tb.rotvec), n(ta.rotvec), atol=2e-6)
    q = np.linspace(-0.08, 0.2, 57).astype(np.float32)
    np.testing.assert_allclose(n(tdk.interpolate_rotation(tb, t(q))),
                               n(jdk.interpolate_rotation(ta, jnp.asarray(q))),
                               atol=2e-6)


@pytest.mark.parametrize("with_pos", [False, True])
def test_deskew(with_pos):
    gyr, times, mask = imu_table_inputs(1)
    xyz, pmask, _ = cloud_arrays(4, N=512)
    ptime = np.random.RandomState(5).uniform(0, 0.1, 512).astype(np.float32)
    ta = jdk.build_rotation_table(jnp.asarray(gyr), jnp.asarray(times),
                                  jnp.asarray(mask))
    tb = tdk.build_rotation_table(t(gyr), t(times), t(mask))
    inc = np.array([0.2, -0.05, 0.01], np.float32)
    a = jdk.deskew(jnp.asarray(xyz), jnp.asarray(ptime), jnp.asarray(pmask), ta,
                   pos_increment=jnp.asarray(inc) if with_pos else None,
                   scan_duration=jnp.float32(0.1) if with_pos else None)
    b = tdk.deskew(t(xyz), t(ptime), t(pmask), tb,
                   pos_increment=t(inc) if with_pos else None,
                   scan_duration=0.1 if with_pos else None)
    np.testing.assert_allclose(n(b), n(a), atol=5e-5)
    np.testing.assert_array_equal(n(b)[~pmask], xyz[~pmask])
