"""The LOAM corner (point-to-line) registration of the port against the JAX
package: `_largest_eigpair_3x3`, `fit_lines`, `find_line_correspondences`,
`register_loam` (brute and grid backends) and `register_loam_with_grid`
(the cases of tests/test_registration.py's TestCornerRegistration, each run
through both).  The brute-force backend of `register` alone is held in
tests/test_torch_loop_closure.py.

Tolerances: line directions within 1e-5 up to sign, validity exact;
correspondence masks exact, weights within 1e-5; registered poses within
1e-4 with equal iteration counts.  The JAX side holds its candidate block
between refreshes through its fused kernel in interpret mode where
`corr_refresh_every > 1` (`torch_port_helpers.jax_fused_interpret`).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_helpers as H
from torch_port_helpers import n, t
from lio_slam_tpu.config import RegistrationConfig as JCfg
from lio_slam_tpu.ops import registration as jreg
from lio_slam_tpu.ops import voxel_grid as jvg
from lio_slam_tpu.utils import se3 as jse3
from lio_slam_tpu_torch.config import RegistrationConfig as TCfg
from lio_slam_tpu_torch.ops import registration as treg
from lio_slam_tpu_torch.ops import voxel_grid as tvg


def line_map(rs, n_lines=8, pts_per_line=40):
    """Edge points along random 3D lines (a corner map)."""
    pts = []
    for _ in range(n_lines):
        o = rs.uniform(-10, 10, 3)
        d = rs.randn(3)
        d /= np.linalg.norm(d)
        s = np.linspace(-4, 4, pts_per_line)
        pts.append(o + s[:, None] * d + rs.randn(pts_per_line, 3) * 0.01)
    return np.concatenate(pts).astype(np.float32)


def scene(seed, true_pose, planar_only=False):
    """(surf_map, surf_scan, corner_map, corner_scan) of the JAX tests."""
    rs = np.random.RandomState(seed)
    if planar_only:
        surf_map = np.stack([rs.uniform(-15, 15, 4096), rs.uniform(-15, 15, 4096),
                             rs.randn(4096) * 0.005], 1).astype(np.float32)
        corner_map = line_map(rs, n_lines=6)
    else:
        corner_map = line_map(rs)
        g = np.stack([rs.uniform(-15, 15, 2048), rs.uniform(-15, 15, 2048),
                      rs.randn(2048) * 0.01], 1)
        w = np.stack([np.full(2048, 9.0) + rs.randn(2048) * 0.01,
                      rs.uniform(-15, 15, 2048), rs.uniform(0, 5, 2048)], 1)
        surf_map = np.concatenate([g, w]).astype(np.float32)
    R, tr = jse3.pose6_to_Rt(jnp.asarray(true_pose))
    surf_scan = np.asarray((jnp.asarray(surf_map[::4]) - tr) @ R)
    corner_scan = np.asarray((jnp.asarray(corner_map[::2]) - tr) @ R)
    return surf_map, surf_scan, corner_map, corner_scan


TRUE = np.array([0.01, -0.02, 0.05, 0.3, -0.2, 0.1], np.float32)
TRUE_PLANAR = np.array([0.0, 0.0, 0.02, 0.2, -0.15, 0.0], np.float32)


def assert_same_result(rp, rj, tol=1e-4):
    assert rp.iterations == int(rj.iterations)
    assert rp.converged == bool(rj.converged)
    assert bool(rp.degenerate) == bool(rj.degenerate)
    assert abs(int(rp.num_inliers) - int(rj.num_inliers)) <= 1
    np.testing.assert_allclose(n(rp.pose), n(rj.pose), atol=tol)


def test_largest_eigpair_matches_jax():
    rs = np.random.RandomState(0)
    a = rs.randn(256, 5, 3).astype(np.float32)
    cov = np.einsum("nki,nkj->nij", a, a) / 5
    lj, mj, vj = jreg._largest_eigpair_3x3(jnp.asarray(cov))
    lp, mp, vp = treg._largest_eigpair_3x3(t(cov))
    np.testing.assert_allclose(n(lp), n(lj), rtol=1e-5)
    np.testing.assert_allclose(n(mp), n(mj), rtol=1e-4, atol=1e-5)
    dots = np.abs(np.sum(n(vp) * n(vj), axis=1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-5)


def test_fit_lines_matches_jax():
    """Noisy lines (valid), a symmetric cross (lam_max == lam_mid: not a
    line), planar patches and neighbourhoods with an invalid neighbour."""
    rs = np.random.RandomState(0)
    d = rs.randn(96, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    s = rs.uniform(-1, 1, (96, 5))
    nb = s[..., None] * d[:, None, :] + rs.randn(96, 5, 3) * 0.005
    nb[64:80] = rs.uniform(-1, 1, (16, 5, 3)) * [1, 1, 0]        # planar
    nb[80:88] = np.array([[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0],
                          [0, -1, 0]])                          # cross
    nb = nb.astype(np.float32)
    valid = np.ones((96, 5), bool)
    valid[88:, 4] = False
    cj, dj, vj = jreg.fit_lines(jnp.asarray(nb), jnp.asarray(valid))
    cp, dp, vp = treg.fit_lines(t(nb), t(valid))
    np.testing.assert_array_equal(n(vp), n(vj))
    assert n(vp)[:64].all() and not n(vp)[80:].any()
    np.testing.assert_allclose(n(cp), n(cj), atol=1e-6)
    dots = np.abs(np.sum(n(dp) * n(dj), axis=1))[:64]
    np.testing.assert_allclose(dots, 1.0, atol=1e-5)


def test_find_line_correspondences_matches_jax():
    _, _, corner_map, corner_scan = scene(2, TRUE)
    mask = np.ones(len(corner_scan), bool)
    mask[::7] = False
    mmask = np.ones(len(corner_map), bool)
    mmask[5::11] = False
    pose = TRUE + np.array([2e-3, -1e-3, 3e-3, 0.05, -0.03, 0.02], np.float32)
    cj = jreg.find_line_correspondences(
        jnp.asarray(corner_scan), jnp.asarray(mask), jnp.asarray(corner_map),
        jnp.asarray(mmask), jnp.asarray(pose), JCfg())
    cp = treg.find_line_correspondences(t(corner_scan), t(mask), t(corner_map),
                                        t(mmask), t(pose), TCfg())
    np.testing.assert_array_equal(n(cp.valid), n(cj.valid))
    assert n(cp.valid).sum() > 50
    np.testing.assert_allclose(n(cp.weight), n(cj.weight), atol=1e-5)
    np.testing.assert_allclose(n(cp.residual), n(cj.residual), atol=1e-5)


@pytest.mark.parametrize("planar_only", [False, True])
def test_register_loam_brute_matches_jax(planar_only):
    truth = TRUE_PLANAR if planar_only else TRUE
    surf_map, surf_scan, corner_map, corner_scan = scene(
        3 if planar_only else 2, truth, planar_only)
    kw = dict(knn_backend="brute", max_iterations=20, degeneracy_eig_thresh=10.0)
    ones = lambda a: np.ones(len(a), bool)
    args = (surf_scan, ones(surf_scan), surf_map, ones(surf_map), corner_scan,
            ones(corner_scan), corner_map, ones(corner_map),
            np.zeros(6, np.float32))
    rj = jreg.register_loam(*map(jnp.asarray, args), JCfg(**kw))
    rp = treg.register_loam(*map(t, args), TCfg(**kw))
    assert_same_result(rp, rj)
    err = np.abs(n(rp.pose) - truth)
    assert err[3:5].max() < 2e-2, err


@pytest.mark.parametrize("refresh", [1, 2])
def test_register_loam_grid_matches_jax(refresh, monkeypatch):
    """The rebuild-mode path: the surface grid built inside, the fused pass
    for the surface term (the plain version on the CPU), the corner term
    evaluated at every iteration."""
    if refresh > 1:
        monkeypatch.setattr(jreg, "_maybe_fused", H.jax_fused_interpret)
    surf_map, surf_scan, corner_map, corner_scan = scene(2, TRUE)
    kw = dict(max_iterations=20, degeneracy_eig_thresh=10.0,
              grid_table_size=4096, corr_refresh_every=refresh)
    ones = lambda a: np.ones(len(a), bool)
    args = (surf_scan, ones(surf_scan), surf_map, ones(surf_map), corner_scan,
            ones(corner_scan), corner_map, ones(corner_map),
            np.zeros(6, np.float32))
    rj = jreg.register_loam(*map(jnp.asarray, args), JCfg(**kw))
    rp = treg.register_loam(*map(t, args), TCfg(**kw))
    assert_same_result(rp, rj)
    assert rp.iterations > 1


@pytest.mark.parametrize("refresh", [1, 2])
def test_register_loam_with_grid_matches_jax(refresh, monkeypatch):
    """The incremental-map path: a persistent grid over the surface map, a
    flat corner map."""
    if refresh > 1:
        monkeypatch.setattr(jreg, "_maybe_fused", H.jax_fused_interpret)
    surf_map, surf_scan, corner_map, corner_scan = scene(2, TRUE)
    ones = lambda a: np.ones(len(a), bool)
    gj = jvg.build_grid(jnp.asarray(surf_map), jnp.asarray(ones(surf_map)),
                        1.0, 4096, 24, halo="z")
    gp = tvg.build_grid(t(surf_map), t(ones(surf_map)), 1.0, 4096, 24,
                        halo="z")
    kw = dict(max_iterations=20, degeneracy_eig_thresh=10.0,
              corr_refresh_every=refresh)
    rest = (corner_scan, ones(corner_scan), corner_map, ones(corner_map),
            np.zeros(6, np.float32))
    rj = jreg.register_loam_with_grid(
        jnp.asarray(surf_scan), jnp.asarray(ones(surf_scan)), gj,
        *map(jnp.asarray, rest), JCfg(**kw))
    rp = treg.register_loam_with_grid(t(surf_scan), t(ones(surf_scan)), gp,
                                      *map(t, rest), TCfg(**kw))
    assert_same_result(rp, rj)
    assert rp.iterations > 1
