"""ops/registration of the port against the JAX package: the GN loop must
take the same number of iterations and end within 1e-4 of the JAX pose.

JAX on the CPU runs its unfused path (`_maybe_fused` returns None there);
the port runs the fused pass's plain version by default, and its own
unfused path with `use_fused_kernel=False`.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import n, planar_scene, t
from lio_slam_tpu.config import RegistrationConfig as JCfg
from lio_slam_tpu.ops import fused_corr as jfc
from lio_slam_tpu.ops import registration as jreg
from lio_slam_tpu.ops import voxel_grid as jvg
from lio_slam_tpu.utils import se3 as jse3
from lio_slam_tpu_torch.config import RegistrationConfig as TCfg
from lio_slam_tpu_torch.ops import registration as treg
from lio_slam_tpu_torch.ops import voxel_grid as tvg
from lio_slam_tpu_torch.utils import smallmat as tsm

INIT = np.array([0.01, -0.02, 0.05, 0.3, -0.2, 0.05], np.float32)


def setup(seed=7, n_map=4096, n_scan=512):
    map_pts, scan = planar_scene(seed, n_map=n_map, n_scan=n_scan)
    mmask = np.ones(len(map_pts), bool)
    ga = jvg.build_grid(jnp.asarray(map_pts), jnp.asarray(mmask), 1.0, 4096, 24,
                        halo="z")
    gb = tvg.build_grid(t(map_pts), t(mmask), 1.0, 4096, 24, halo="z")
    return scan, ga, gb


def jax_register_held(scan, mask, grid, init, cfg):
    """JAX's GN loop through its fused kernel (Pallas interpret mode) with
    the candidate block held for `corr_refresh_every` iterations — the path
    `_maybe_fused` takes off the CPU."""
    kw = dict(halo="z", nn_radius=cfg.nn_radius,
              plane_dist_thresh=cfg.plane_dist_thresh,
              robust_weight_floor=cfg.robust_weight_floor, tile=128,
              interpret=True)

    def gather_fn(pose):
        R, tr = jse3.pose6_to_Rt(pose)
        return jfc.gather_planar(grid, jse3.transform_points(R, tr, scan), "z")

    def from_cand_fn(cand, hh, pose):
        return jfc.fused_ne_from_candidates(cand, hh, scan, mask, pose, **kw)

    return jreg._gn_loop(scan, mask, None, init, cfg, jnp.ones((), bool), 50,
                         ne_fn=(gather_fn, from_cand_fn, cfg.corr_refresh_every))


@pytest.mark.parametrize("refresh,fused,seed", [(1, True, 7), (2, True, 7),
                                                (1, False, 7), (2, True, 11)])
def test_register_with_grid_matches(refresh, fused, seed):
    scan, ga, gb = setup(seed)
    mask = np.ones(len(scan), bool)
    if refresh == 1:
        ra = jreg.register_with_grid(jnp.asarray(scan), jnp.asarray(mask), ga,
                                     jnp.asarray(INIT), JCfg())
    else:
        ra = jax_register_held(jnp.asarray(scan), jnp.asarray(mask), ga,
                               jnp.asarray(INIT),
                               JCfg(corr_refresh_every=refresh))
    rb = treg.register_with_grid(t(scan), t(mask), gb, t(INIT),
                                 TCfg(corr_refresh_every=refresh,
                                      use_fused_kernel=fused))
    assert rb.iterations == int(ra.iterations)
    assert rb.converged == bool(ra.converged)
    assert int(rb.num_inliers) == int(ra.num_inliers)
    assert bool(rb.degenerate) == bool(ra.degenerate)
    np.testing.assert_allclose(n(rb.pose), n(ra.pose), atol=1e-4)
    np.testing.assert_allclose(float(rb.mean_residual), float(ra.mean_residual),
                               rtol=1e-3, atol=1e-5)
    assert rb.iterations > 1


def test_gn_stops_at_iteration_cap():
    scan, ga, gb = setup(3)
    mask = np.ones(len(scan), bool)
    far = INIT * 3
    ra = jreg.register_with_grid(jnp.asarray(scan), jnp.asarray(mask), ga,
                                 jnp.asarray(far), JCfg(max_iterations=2))
    rb = treg.register_with_grid(t(scan), t(mask), gb, t(far),
                                 TCfg(max_iterations=2))
    assert rb.iterations == int(ra.iterations) == 2
    np.testing.assert_allclose(n(rb.pose), n(ra.pose), atol=1e-4)


def test_not_runnable_returns_initial_pose():
    scan, _, gb = setup()
    mask = np.zeros(len(scan), bool)
    mask[:20] = True                                    # <= 30 scan points
    rb = treg.register_with_grid(t(scan), t(mask), gb, t(INIT), TCfg())
    assert rb.iterations == 0 and rb.converged
    np.testing.assert_array_equal(n(rb.pose), INIT)
    empty = tvg.empty_grid(1.0, 256, 24)
    rb = treg.register_with_grid(t(scan), t(np.ones(len(scan), bool)), empty,
                                 t(INIT), TCfg())
    assert rb.iterations == 0


def test_fit_planes_and_degeneracy_projection():
    rs = np.random.RandomState(1)
    nb = (rs.randn(200, 5, 3) * [1.0, 1.0, 0.02]).astype(np.float32)
    nbv = rs.uniform(size=(200, 5)) > 0.05
    na, oa, va = jreg.fit_planes(jnp.asarray(nb), jnp.asarray(nbv), 0.2)
    nt, ot, vt = treg.fit_planes(t(nb), t(nbv), 0.2)
    np.testing.assert_array_equal(n(vt), n(va))
    sign = np.sign(np.sum(n(nt) * n(na), axis=1))[:, None]
    np.testing.assert_allclose(n(nt) * sign, n(na), atol=1e-5)
    A = rs.randn(6, 6).astype(np.float32)
    A = (A @ A.T * 50).astype(np.float32)
    Pa, da = jreg._degeneracy_projection(jnp.asarray(A), 100.0)
    Pt, dt = treg._degeneracy_projection(*tsm.eigh_jacobi(t(A)), 100.0)
    assert bool(dt) == bool(da)
    np.testing.assert_allclose(n(Pt), n(Pa), atol=1e-4)


@pytest.mark.parametrize("avail", [True, False])
def test_transform_update(avail):
    pose = np.array([0.05, -0.03, 1.2, 3.0, 4.0, 25.0], np.float32)
    imu = np.array([0.01, 0.02, 0.0], np.float32)
    a = jreg.transform_update(jnp.asarray(pose), jnp.asarray(imu),
                              jnp.asarray(avail), 0.01, rotation_tolerance=0.04,
                              z_tolerance=20.0)
    b = treg.transform_update(t(pose), t(imu), t(np.bool_(avail)), 0.01,
                              rotation_tolerance=0.04, z_tolerance=20.0)
    np.testing.assert_allclose(n(b), n(a), atol=1e-6)
