"""The fused correspondence pass of the port (ops/fused_corr.py), mirroring
tests/test_fused_corr.py at halo "z".

On CPU tensors the wrapper runs the plain PyTorch version, which is held to
the JAX kernel in Pallas interpret mode and to the unfused JAX path with the
kernel contract: inlier count exact, AtA / Atb within rtol 2e-4 / atol 2e-3,
the Σ terms within rtol 1e-4.  The CUDA kernel itself is compared with the
plain version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, planar_scene, t
from lio_slam_tpu.config import RegistrationConfig
from lio_slam_tpu.ops import fused_corr as jfc
from lio_slam_tpu.ops import registration as jreg
from lio_slam_tpu.ops import voxel_grid as jvg
from lio_slam_tpu.utils import se3 as jse3
from lio_slam_tpu_torch.ops import _build
from lio_slam_tpu_torch.ops import fused_corr as tfc
from lio_slam_tpu_torch.ops import voxel_grid as tvg
from lio_slam_tpu_torch.utils import se3 as tse3

CFG = RegistrationConfig()
KW = dict(nn_radius=CFG.nn_radius, plane_dist_thresh=CFG.plane_dist_thresh,
          robust_weight_floor=CFG.robust_weight_floor)
POSE = np.array([0.02, -0.01, 0.3, 0.5, -0.2, 0.1], np.float32)


def grids(map_pts, table_size=4096, cap=24):
    mmask = np.ones(len(map_pts), bool)
    return (jvg.build_grid(jnp.asarray(map_pts), jnp.asarray(mmask), 1.0,
                           table_size, cap, halo="z"),
            tvg.build_grid(t(map_pts), t(mmask), 1.0, table_size, cap, halo="z"))


def assert_ne_close(port, ref):
    AtA, Atb, n_inl, wsum, wres = port
    assert int(n_inl) == int(ref[2])
    np.testing.assert_allclose(n(AtA), n(ref[0]), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(n(Atb), n(ref[1]), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(float(wsum), float(ref[3]), rtol=1e-4)
    np.testing.assert_allclose(float(wres), float(ref[4]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 5])
def test_plain_matches_jax_kernel_interpret(seed):
    map_pts, scan = planar_scene(seed)
    mask = np.ones(len(scan), bool)
    ga, gb = grids(map_pts)
    ref = jfc.fused_normal_equations(ga, jnp.asarray(scan), jnp.asarray(mask),
                                     jnp.asarray(POSE), halo="z", tile=128,
                                     interpret=True, **KW)
    port = tfc.fused_normal_equations(gb, t(scan), t(mask), t(POSE), **KW)
    assert_ne_close(port, ref)
    assert int(port[2]) > 100
    assert port[0].dtype == torch.float32 and port[2].dtype == torch.int32


def test_plain_matches_jax_unfused():
    map_pts, scan = planar_scene(1)
    mask = np.ones(len(scan), bool)
    ga, gb = grids(map_pts)
    corr = jreg.find_correspondences(jnp.asarray(scan), jnp.asarray(mask), None,
                                     None, jnp.asarray(POSE), CFG, grid=ga)
    AtA, Atb = jreg._normal_equations(jnp.asarray(scan), corr, jnp.asarray(POSE))
    ref = (AtA, Atb, int(jnp.sum(corr.valid)), float(jnp.sum(corr.weight)),
           float(jnp.sum(corr.weight * jnp.abs(corr.residual))))
    assert_ne_close(tfc.fused_normal_equations(gb, t(scan), t(mask), t(POSE), **KW),
                    ref)


def test_respects_scan_mask():
    map_pts, scan = planar_scene(3)
    N = len(scan)
    mask = np.arange(N) < N // 2
    ga, gb = grids(map_pts)
    ref = jfc.fused_normal_equations(ga, jnp.asarray(scan), jnp.asarray(mask),
                                     jnp.zeros(6), halo="z", tile=128,
                                     interpret=True, **KW)
    port = tfc.fused_normal_equations(gb, t(scan), t(mask),
                                      torch.zeros(6), **KW)
    assert_ne_close(port, ref)
    assert 0 < int(port[2]) <= N // 2


def test_empty_map_gives_zeros():
    grid = tvg.empty_grid(1.0, 1024, 24)
    scan = np.random.RandomState(0).uniform(-5, 5, (128, 3)).astype(np.float32)
    AtA, Atb, n_inl, wsum, wres = tfc.fused_normal_equations(
        grid, t(scan), torch.ones(128, dtype=torch.bool), torch.zeros(6), **KW)
    assert int(n_inl) == 0
    assert float(AtA.abs().sum()) == 0.0 and float(Atb.abs().sum()) == 0.0
    assert float(wsum) == 0.0 and float(wres) == 0.0


def test_held_bucket_ids():
    """corr_refresh_every > 1: bucket ids held from a nearby pose, 5-NN
    re-selected at the evaluation pose — the JAX held-candidate variant."""
    map_pts, scan = planar_scene(2)
    mask = np.ones(len(scan), bool)
    ga, gb = grids(map_pts)
    pose1 = POSE + np.array([1e-4, -2e-4, 3e-4, 0.004, -0.003, 0.002], np.float32)
    R0, t0 = jse3.pose6_to_Rt(jnp.asarray(POSE))
    cand, hh = jfc.gather_planar(ga, jse3.transform_points(R0, t0, jnp.asarray(scan)),
                                 "z")
    ref = jfc.fused_ne_from_candidates(cand, hh, jnp.asarray(scan),
                                       jnp.asarray(mask), jnp.asarray(pose1),
                                       halo="z", tile=128, interpret=True, **KW)
    Rt, tt = tse3.pose6_to_Rt(t(POSE))
    hh_t = tvg.bucket_ids(tse3.transform_points(Rt, tt, t(scan)), gb.cell_size,
                          gb.table.shape[0])
    np.testing.assert_array_equal(n(hh_t), np.asarray(hh))
    held = tfc.fused_ne_from_bucket_ids(gb.table, hh_t, t(scan), t(mask),
                                        t(pose1), **KW)
    assert_ne_close(held, ref)
    fresh = tfc.fused_normal_equations(gb, t(scan), t(mask), t(pose1), **KW)
    assert abs(int(held[2]) - int(fresh[2])) <= max(2, int(0.01 * len(scan)))


def test_out_of_table_ids_read_as_empty_buckets():
    """An id outside [0, T) gives what the id of an empty bucket gives (the
    kernel skips such an id rather than read outside the table)."""
    map_pts, scan = planar_scene(6)
    _, gb = grids(map_pts)
    T = gb.table.shape[0]
    mask = torch.ones(len(scan), dtype=torch.bool)
    Rt, tt = tse3.pose6_to_Rt(t(POSE))
    hh = tvg.bucket_ids(tse3.transform_points(Rt, tt, t(scan)), gb.cell_size, T)
    empty_id = int(torch.nonzero(gb.counts == 0)[0, 0])
    bad, as_empty = hh.clone(), hh.clone()
    for o, cols, v in ((0, slice(0, None, 5), T + 7), (4, slice(1, None, 3), -3),
                       (8, slice(None), 2 ** 31 - 1)):
        bad[o, cols] = v
        as_empty[o, cols] = empty_id
    got = tfc.fused_ne_from_bucket_ids(gb.table, bad, t(scan), mask, t(POSE), **KW)
    want = tfc.fused_ne_from_bucket_ids(gb.table, as_empty, t(scan), mask,
                                        t(POSE), **KW)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(n(a), n(b))
    assert 0 < int(got[2]) < int(tfc.fused_ne_from_bucket_ids(
        gb.table, hh, t(scan), mask, t(POSE), **KW)[2])


def test_non_finite_points_contribute_nothing():
    """A point with a NaN or an infinity, masked or not, leaves the sums
    what they are without it.  The JAX kernel departs here: the point's zero
    weight meets a non-finite Jacobian row and AtA comes out NaN."""
    map_pts, scan = planar_scene(7)
    ga, gb = grids(map_pts)
    bad = scan.copy()
    bad[3] = np.nan
    bad[50, 1] = np.inf
    bad[51] = np.nan
    bad[100, 2] = -np.inf
    mask = np.ones(len(scan), bool)
    mask[[51, 100]] = False
    got = tfc.fused_normal_equations(gb, t(bad), t(mask), t(POSE), **KW)
    ok = np.isfinite(bad).all(axis=1)
    want = tfc.fused_normal_equations(gb, t(np.where(ok[:, None], bad, 0.0)),
                                      t(mask & ok), t(POSE), **KW)
    assert int(got[2]) > 100
    for a, b in zip(got, want):
        np.testing.assert_array_equal(n(a), n(b))
    ref = jfc.fused_normal_equations(ga, jnp.asarray(bad), jnp.asarray(mask),
                                     jnp.asarray(POSE), halo="z", tile=128,
                                     interpret=True, **KW)
    assert not np.isfinite(n(ref[0])).all()


def test_cpu_tensors_never_launch_the_kernel():
    map_pts, scan = planar_scene(4, n_scan=256)
    _, gb = grids(map_pts)
    before = _build.LAUNCHES.copy(), _build.CAPTURED.copy()
    out = tfc.fused_normal_equations(gb, t(scan), torch.ones(256, dtype=torch.bool),
                                     t(POSE), **KW)
    ref = tfc.fused_normal_equations_ref(gb, t(scan),
                                         torch.ones(256, dtype=torch.bool),
                                         t(POSE), **KW)
    assert (_build.LAUNCHES, _build.CAPTURED) == before
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(n(a), n(b))


def test_unpack_layout():
    """The kernel's 45 output words, as the wrapper hands them out."""
    out = torch.arange(tfc.OUT_WORDS, dtype=torch.float32)
    out[44:].view(torch.int32)[0] = 27
    AtA, Atb, n_inl, wsum, wres = tfc._views(out)
    assert AtA.shape == (6, 6) and AtA[0].tolist() == [0, 1, 2, 3, 4, 5]
    assert AtA[1, 1] == 7 and AtA[5, 5] == 35
    assert Atb.tolist() == [36, 37, 38, 39, 40, 41]
    assert n_inl.dtype == torch.int32 and n_inl.dim() == 0 and int(n_inl) == 27
    assert float(wsum) == 42 and float(wres) == 43
    for x in (AtA, Atb, n_inl, wsum, wres):       # views: nothing is copied
        assert x.untyped_storage().data_ptr() == out.untyped_storage().data_ptr()
