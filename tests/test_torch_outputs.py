"""The map products of the port against the JAX package (mirrors
tests/test_outputs.py): PCD files, the height map and its filter layers,
the halo "none" grid, statistical outlier removal, the local planning map
and the map export, on the same seeded numpy inputs.

Tolerances: PCD files, grid tables / counts / k-NN neighbours and
validity, outlier masks, height-map counts and empty cells are bit-equal
(integer and comparison logic); k-NN squared distances within rtol 1e-6
(XLA may contract the sum of squares into fused multiply-adds); elevations
are exact (max / min of the inputs); normals, slopes and distances within 1e-6 (float32 rounding of
the same formulas); planning-map points within 1e-5 m (centroids of the
same points summed in another order)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import n, t
from lio_slam_tpu.config import Config as JConfig, StaticConfig as JStatic
from lio_slam_tpu.io import pcd as jpcd
from lio_slam_tpu.ops import heightmap as jhm
from lio_slam_tpu.ops import voxel_grid as jvg
from lio_slam_tpu.pipeline import keyframes as jkf
from lio_slam_tpu.pipeline import outputs as jout
from lio_slam_tpu.utils import pointcloud as jpc
from lio_slam_tpu_torch.config import Config, StaticConfig
from lio_slam_tpu_torch.io import pcd as tpcd
from lio_slam_tpu_torch.ops import heightmap as thm
from lio_slam_tpu_torch.ops import voxel_grid as tvg
from lio_slam_tpu_torch.pipeline import keyframes as tkf
from lio_slam_tpu_torch.pipeline import outputs as tout
from lio_slam_tpu_torch.utils import pointcloud as tpc


class TestPcd:
    def test_binary_roundtrip_across_packages(self, tmp_path):
        rs = np.random.RandomState(0)
        xyz = rs.randn(500, 3).astype(np.float32)
        inten = rs.rand(500).astype(np.float32)
        a, b = str(tmp_path / "a.pcd"), str(tmp_path / "b.pcd")
        tpcd.save_pcd(a, xyz, intensity=inten, extra_fields={"time": inten * 2})
        jpcd.save_pcd(b, xyz, intensity=inten, extra_fields={"time": inten * 2})
        assert open(a, "rb").read() == open(b, "rb").read()
        xyz2, attrs = tpcd.load_pcd(b)
        np.testing.assert_array_equal(xyz2, xyz)
        np.testing.assert_array_equal(attrs["intensity"], inten)
        np.testing.assert_array_equal(attrs["time"], inten * 2)

    def test_ascii_roundtrip(self, tmp_path):
        xyz = np.array([[1.5, -2.0, 3.25], [0, 0, 0]], np.float32)
        p = str(tmp_path / "b.pcd")
        tpcd.save_pcd(p, xyz, binary=False)
        xyz2, _ = tpcd.load_pcd(p)
        np.testing.assert_allclose(xyz, xyz2, atol=1e-5)
        np.testing.assert_array_equal(xyz2, jpcd.load_pcd(p)[0])


def both_rasterize(xyz, mask, center, res, shape):
    a = jhm.rasterize(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(center),
                      resolution=res, shape=shape)
    b = thm.rasterize(t(xyz), t(mask), t(center), resolution=res, shape=shape)
    return a, b


def assert_hm_equal(a, b):
    np.testing.assert_array_equal(n(b.count), n(a.count))
    np.testing.assert_array_equal(n(b.elevation), n(a.elevation))
    np.testing.assert_array_equal(n(b.min_z), n(a.min_z))
    np.testing.assert_array_equal(n(b.origin), n(a.origin))
    assert float(b.resolution) == float(a.resolution)


class TestHeightMap:
    def test_rasterize_matches_jax(self):
        rs = np.random.RandomState(0)
        flat = np.stack([rs.uniform(0, 1, 200), rs.uniform(0, 1, 200),
                         np.full(200, 1.0)], 1)
        cloud = np.concatenate([flat, [[3.05, 3.05, 5.0]],
                                rs.uniform(-9, 9, (300, 3))]).astype(np.float32)
        mask = rs.uniform(size=len(cloud)) > 0.1
        mask[:201] = True
        center = np.array([0.3, -0.2], np.float32)
        a, b = both_rasterize(cloud, mask, center, 0.5, (32, 32))
        assert_hm_equal(a, b)
        e, origin = n(b.elevation), n(b.origin)
        i, j = int((3.05 - origin[0]) / 0.5), int((3.05 - origin[1]) / 0.5)
        assert e[i, j] == pytest.approx(5.0)
        assert int(n(b.count).sum()) == int(
            (mask & (np.abs(cloud[:, 0] - 0.3) < 8) & (np.abs(cloud[:, 1] + 0.2) < 8)).sum())

    def test_counts_and_minz(self):
        xyz = np.array([[0.1, 0.1, 1.0], [0.15, 0.12, 3.0]], np.float32)
        a, b = both_rasterize(xyz, np.ones(2, bool), np.zeros(2, np.float32),
                              1.0, (8, 8))
        assert_hm_equal(a, b)
        c = n(b.count)
        assert c.sum() == 2 and c.dtype == np.int32
        ij = np.argwhere(c == 2)[0]
        assert n(b.min_z)[ij[0], ij[1]] == 1.0
        assert n(b.elevation)[ij[0], ij[1]] == 3.0

    @pytest.mark.parametrize("iterations", [1, 4])
    def test_inpaint_matches_jax(self, iterations):
        rs = np.random.RandomState(1)
        xyz = rs.uniform(-3, 3, (40, 3)).astype(np.float32)
        a, b = both_rasterize(xyz, np.ones(40, bool), np.zeros(2, np.float32),
                              0.5, (16, 16))
        ea = np.asarray(jhm.inpaint_nearest(a, iterations))
        eb = n(thm.inpaint_nearest(b, iterations))
        np.testing.assert_array_equal(np.isnan(eb), np.isnan(ea))
        np.testing.assert_allclose(eb, ea, atol=1e-6)
        assert np.isfinite(eb).sum() > np.isfinite(n(b.elevation)).sum()


def plane_hm(mod, elev, res=0.5):
    H, W = elev.shape
    arr = (lambda x: jnp.asarray(x)) if mod is jhm else t
    return mod.HeightMap(elevation=arr(elev.astype(np.float32)),
                         min_z=arr(elev.astype(np.float32)),
                         count=arr(np.ones((H, W), np.int32)),
                         origin=arr(np.zeros(2, np.float32)),
                         resolution=arr(np.float32(res)))


def terrain(kind):
    ii, jj = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    e = (0.1 * ii * 0.5).astype(np.float32)
    if kind == "nan":
        e[5, 5] = np.nan
        e[20:23, 7] = np.nan
    elif kind == "edge":
        e = np.zeros((32, 32), np.float32)
        e[-1, :] = 10.0
    elif kind == "block":
        e = np.zeros((32, 32), np.float32)
        e[10:14, 10:14] = 2.0
    return e


class TestFilterLayers:
    @pytest.mark.parametrize("kind", ["plane", "nan", "edge"])
    def test_normals_slope_match_jax(self, kind):
        e = terrain(kind)
        na, sa = jhm.normals_and_slope(plane_hm(jhm, e))
        nb, sb = thm.normals_and_slope(plane_hm(thm, e))
        np.testing.assert_array_equal(np.isnan(n(sb)), np.isnan(np.asarray(sa)))
        np.testing.assert_allclose(n(sb), np.asarray(sa), atol=1e-6)
        np.testing.assert_allclose(n(nb), np.asarray(na), atol=1e-6)
        if kind == "plane":
            np.testing.assert_allclose(n(sb)[2:-2, 2:-2], np.arctan(0.1), atol=1e-3)
        if kind == "edge":
            assert n(sb)[0, 5] < 1e-3 and n(sb)[-2, 5] > 1.0

    def test_sdf_matches_jax_and_bruteforce(self):
        rng = np.random.default_rng(3)
        occ = rng.random((48, 48)) < 0.04
        occ[20:24, 20:24] = True
        da = np.asarray(jhm.signed_distance_2d(jnp.asarray(occ), 1.0))
        db = n(thm.signed_distance_2d(t(occ), 1.0))
        np.testing.assert_allclose(db, da, atol=1e-6)
        grid = np.stack(np.meshgrid(np.arange(48), np.arange(48), indexing="ij"),
                        -1).reshape(-1, 2)
        pts = np.argwhere(occ).astype(np.float64)
        free = np.argwhere(~occ).astype(np.float64)
        d_occ = np.sqrt(((grid[:, None] - pts[None]) ** 2).sum(-1)).min(1)
        d_free = np.sqrt(((grid[:, None] - free[None]) ** 2).sum(-1)).min(1)
        ref = np.where(occ.reshape(-1), -d_free, d_occ).reshape(48, 48)
        assert np.abs(db - ref).max() <= 1.0 + 1e-6
        assert (np.abs(db - ref) < 1e-5).mean() > 0.98

    def test_obstacle_sdf_matches_jax(self):
        e = terrain("block")
        da = np.asarray(jhm.obstacle_sdf(plane_hm(jhm, e), 0.0, clearance=0.3))
        db = n(thm.obstacle_sdf(plane_hm(thm, e), 0.0, clearance=0.3))
        np.testing.assert_allclose(db, da, atol=1e-6)
        assert db[12, 12] < 0 and db[0, 0] > 5 * 0.5 - 1e-3


def cloud_scene(seed=0, m=600):
    rs = np.random.RandomState(seed)
    pts = np.concatenate([rs.rand(m, 3) * 4.0,
                          rs.uniform(0.05, 0.95, (60, 3)) + [1.0, 1.0, 1.0],
                          [[50.0, 50.0, 50.0]]]).astype(np.float32)
    mask = rs.uniform(size=len(pts)) > 0.05
    mask[-1] = True
    return pts, mask


class TestHaloNone:
    """The layout the outlier removal uses: one insert a point, 27 cells a
    query in the JAX package's meshgrid order (ties go to the lowest row)."""

    def test_query_offsets_in_jax_order(self):
        np.testing.assert_array_equal(n(tvg.query_offsets("cpu", "none")),
                                      np.asarray(jvg._QUERY_OFFSETS["none"]))
        np.testing.assert_array_equal(n(tvg.insert_offsets("cpu", "none")),
                                      np.asarray(jvg._INSERT_OFFSETS["none"]))

    @pytest.mark.parametrize("seed", [0, 1])
    def test_build_insert_query_bit_equal(self, seed):
        pts, mask = cloud_scene(seed)
        half = len(pts) // 2
        ga = jvg.build_grid(jnp.asarray(pts[:half]), jnp.asarray(mask[:half]),
                            0.5, 512, 8, halo="none")
        gb = tvg.build_grid(t(pts[:half]), t(mask[:half]), 0.5, 512, 8,
                            halo="none")
        ga = jvg.insert_points(ga, jnp.asarray(pts[half:]),
                               jnp.asarray(mask[half:]), halo="none")
        gb = tvg.insert_points(gb, t(pts[half:]), t(mask[half:]), halo="none")
        np.testing.assert_array_equal(n(gb.counts), n(ga.counts))
        np.testing.assert_array_equal(n(gb.table), n(ga.table))
        np.testing.assert_array_equal(
            n(tvg.bucket_ids(t(pts), gb.cell_size, 512, "none")),
            (lambda q: np.abs(
                (q[..., 0] * np.int32(73856093)) ^ (q[..., 1] * np.int32(19349663))
                ^ (q[..., 2] * np.int32(83492791))) % 512)(
                np.floor(pts / 0.5).astype(np.int32)[None]
                + np.asarray(jvg._QUERY_OFFSETS["none"], np.int32)[:, None]))
        ra = jvg.query_knn(ga, jnp.asarray(pts), jnp.asarray(mask), k=6, halo="none")
        rb = tvg.query_knn(gb, t(pts), t(mask), k=6, halo="none")
        np.testing.assert_array_equal(n(rb.valid), n(ra.valid))
        np.testing.assert_allclose(n(rb.dist2), n(ra.dist2), rtol=1e-6)
        np.testing.assert_array_equal(n(rb.neighbors)[n(ra.valid)],
                                      n(ra.neighbors)[n(ra.valid)])

    def test_unknown_halo_refused(self):
        for halo in ("", "xyz"):
            with pytest.raises(ValueError, match="grid_halo"):
                tvg.build_grid(t(np.zeros((4, 3), np.float32)),
                               t(np.ones(4, bool)), 1.0, 64, 4, halo=halo)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_statistical_outlier_mask_matches_jax(seed):
    pts, mask = cloud_scene(seed)
    a = np.asarray(jout.statistical_outlier_mask(jnp.asarray(pts), jnp.asarray(mask)))
    b = n(tout.statistical_outlier_mask(t(pts), t(mask)))
    np.testing.assert_array_equal(b, a)
    assert not b[-1] and b.sum() > 0.8 * mask.sum()


def ground_stores(n_kf=4):
    """The store of tests/test_outputs.py, built in both packages."""
    ja, tb = jkf.empty_store(16, 512), tkf.empty_store(16, 512)
    rs = np.random.RandomState(0)
    for i in range(n_kf):
        pts = np.stack([rs.uniform(-5, 5, 400), rs.uniform(-5, 5, 400),
                        rs.randn(400) * 0.02], 1).astype(np.float32)
        pose = np.array([0, 0, 0.1 * i, 2.0 * i, 0, 0], np.float32)
        ja = jkf.add_keyframe(ja, jnp.asarray(pose), jnp.float32(i * 0.5),
                              jpc.pad_cloud(pts, 512))
        tb = tkf.add_keyframe(tb, t(pose), t(np.float32(i * 0.5)),
                              tpc.pad_cloud(pts, 512))
    return ja, tb


def test_pad_cloud_matches_jax():
    pts = np.random.RandomState(2).randn(7, 3).astype(np.float32)
    for cap in (4, 7, 16):
        a, b = jpc.pad_cloud(pts, cap), tpc.pad_cloud(pts, cap)
        np.testing.assert_array_equal(n(b.xyz), n(a.xyz))
        np.testing.assert_array_equal(n(b.mask), n(a.mask))


def test_local_planning_map_and_height_map_match_jax():
    ja, tb = ground_stores()
    # the JAX test's store; the planning map's capacity cut from 65536 to
    # 8192 (the 4 x 400 points fit) to keep the JAX run short
    jfn, jheight = jout.make_local_map_fn(JConfig(static=JStatic(
        max_keyframes=16, max_keyframe_points=512, max_map_points=8192)))
    tfn, theight = tout.make_local_map_fn(Config(static=StaticConfig(
        max_keyframes=16, max_keyframe_points=512, max_map_points=8192)))
    pose = np.array([0, 0, 0.3, 4.0, 0, 0], np.float32)
    ma, mb = jfn(ja, jnp.asarray(pose)), tfn(tb, t(pose))
    np.testing.assert_array_equal(n(mb.mask), n(ma.mask))
    keep = n(ma.mask)
    assert keep.sum() > 100
    np.testing.assert_allclose(n(mb.xyz)[keep], n(ma.xyz)[keep], atol=1e-5)
    rel = n(mb.xyz)[keep][:, :2] - np.array([4.0, 0])
    c, s = np.cos(-0.3), np.sin(-0.3)
    assert np.abs(rel[:, 0] * c - rel[:, 1] * s).max() <= 40.0 + 1e-3
    ha, hb = jheight(ma, jnp.asarray(pose)), theight(mb, t(pose))
    np.testing.assert_array_equal(n(hb.count), n(ha.count))
    np.testing.assert_array_equal(np.isnan(n(hb.elevation)), np.isnan(n(ha.elevation)))
    np.testing.assert_allclose(n(hb.elevation), n(ha.elevation), atol=1e-5)
    assert np.isfinite(n(hb.elevation)).sum() > 50


def test_save_map_matches_jax(tmp_path):
    ja, tb = ground_stores()
    ra = jout.save_map(ja, str(tmp_path / "jax"), resolution=0.4)
    rb = tout.save_map(tb, str(tmp_path / "port"), resolution=0.4)
    assert rb.success and ra.success and rb.num_points == ra.num_points > 100
    assert [os.path.basename(f) for f in rb.files] == \
        [os.path.basename(f) for f in ra.files]
    for name in ("trajectory.pcd", "transformations.pcd"):
        xa, aa = jpcd.load_pcd(str(tmp_path / "jax" / name))
        xb, ab = tpcd.load_pcd(str(tmp_path / "port" / name))
        np.testing.assert_array_equal(xb, xa)
        for k in aa:
            np.testing.assert_array_equal(ab[k], aa[k])
    ga, _ = jpcd.load_pcd(str(tmp_path / "jax" / "GlobalMap.pcd"))
    gb, _ = tpcd.load_pcd(str(tmp_path / "port" / "GlobalMap.pcd"))
    np.testing.assert_allclose(gb, ga, atol=1e-5)
    sb, _ = tpcd.load_pcd(str(tmp_path / "port" / "SurfMap.pcd"))
    np.testing.assert_array_equal(sb, gb)
    np.testing.assert_array_equal(
        np.load(str(tmp_path / "port" / "transformations.npz"))["poses"],
        np.load(str(tmp_path / "jax" / "transformations.npz"))["poses"])


def test_save_empty_store(tmp_path):
    res = tout.save_map(tkf.empty_store(8, 64), str(tmp_path / "m2"))
    assert not res.success and res.files == []
    assert not os.path.exists(str(tmp_path / "m2"))
