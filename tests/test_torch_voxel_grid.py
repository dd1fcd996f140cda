"""ops/voxel_grid of the port against the JAX package (halo "z").

Bucket ids, tables and counts must be bit-identical: the int32 hash wraps
the same way, `abs(INT_MIN)` stays INT_MIN and both `%` are floor-mod, and
the stable sort keeps the same points when a bucket overflows.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import n, t
from lio_slam_tpu.ops import fused_corr as jfc
from lio_slam_tpu.ops import voxel_grid as jvg
from lio_slam_tpu_torch.ops import voxel_grid as tvg

# (x, y, 0) hashes to exactly INT_MIN: 73856093*x ^ 19349663*y wraps to -2^31
INT_MIN_CELL = (-165649, 54605, 0)
T_SIZE, CAP = 4096, 8


def scene(seed=0):
    rs = np.random.RandomState(seed)
    pts = [rs.uniform(-12, 12, (1500, 3)),
           rs.uniform(0.1, 0.9, (40, 3)) + [2.0, 3.0, 0.0],     # 40 > CAP in one cell
           rs.uniform(0.1, 0.9, (6, 3)) + np.add(INT_MIN_CELL, (0, 0, 1)),
           rs.uniform(0.1, 0.9, (6, 3)) + np.add(INT_MIN_CELL, (1, 0, 0))]
    pts = np.concatenate(pts).astype(np.float32)
    mask = rs.uniform(size=len(pts)) > 0.05
    return pts, mask


def test_int_min_cell_hash():
    cell = np.array([INT_MIN_CELL], np.int32)
    h_raw = (cell[:, 0] * np.int32(73856093)) ^ (cell[:, 1] * np.int32(19349663))
    assert h_raw[0] == np.iinfo(np.int32).min
    for T in (4096, 32768, 1000):
        assert int(n(tvg._cell_hash(t(cell), T))[0]) == \
            int(np.asarray(jvg._cell_hash(jnp.asarray(cell), T))[0])


def test_bucket_ids_bit_identical():
    pts, _ = scene()
    for T in (T_SIZE, 1000):
        grid = jvg.empty_grid(1.0, T, CAP)
        _, hh = jfc.gather_planar(grid, jnp.asarray(pts), "z")
        hh_t = tvg.bucket_ids(t(pts), tvg.empty_grid(1.0, T, CAP).cell_size, T)
        np.testing.assert_array_equal(n(hh_t), np.asarray(hh))
        assert n(hh_t).dtype == np.int32
    assert (n(hh_t) == 0).any()


@pytest.mark.parametrize("chunk", [262144, 500])
def test_build_then_insert_identical(chunk):
    pts, mask = scene(1)
    more, mmask = scene(2)
    ga = jvg.build_grid(jnp.asarray(pts), jnp.asarray(mask), 1.0, T_SIZE, CAP,
                        halo="z", chunk=chunk)
    gb = tvg.build_grid(t(pts), t(mask), 1.0, T_SIZE, CAP, halo="z", chunk=chunk)
    np.testing.assert_array_equal(n(gb.table), n(ga.table))
    np.testing.assert_array_equal(n(gb.counts), n(ga.counts))
    assert n(gb.counts).max() == CAP                  # an overflowing bucket
    ga = jvg.insert_points(ga, jnp.asarray(more), jnp.asarray(mmask), halo="z")
    gb = tvg.insert_points(gb, t(more), t(mmask), halo="z")
    np.testing.assert_array_equal(n(gb.table), n(ga.table))
    np.testing.assert_array_equal(n(gb.counts), n(ga.counts))


def test_query_knn_matches():
    pts, mask = scene(3)
    ga = jvg.build_grid(jnp.asarray(pts), jnp.asarray(mask), 1.0, T_SIZE, CAP,
                        halo="z")
    gb = tvg.build_grid(t(pts), t(mask), 1.0, T_SIZE, CAP, halo="z")
    rs = np.random.RandomState(4)
    q = (pts[rs.permutation(len(pts))[:300]]
         + rs.randn(300, 3).astype(np.float32) * 0.1).astype(np.float32)
    qmask = rs.uniform(size=300) > 0.1
    ra = jvg.query_knn(ga, jnp.asarray(q), jnp.asarray(qmask), k=5, halo="z")
    rb = tvg.query_knn(gb, t(q), t(qmask), k=5, halo="z")
    np.testing.assert_array_equal(n(rb.valid), n(ra.valid))
    v = n(ra.valid)
    np.testing.assert_allclose(n(rb.dist2)[v], n(ra.dist2)[v], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(rb.neighbors)[v], n(ra.neighbors)[v], atol=1e-6)


def test_unknown_halo_refused():
    with pytest.raises(ValueError, match="grid_halo"):
        tvg.bucket_ids(t(np.zeros((4, 3), np.float32)),
                       tvg.empty_grid(1.0, 64, 4).cell_size, 64, halo="zz")
