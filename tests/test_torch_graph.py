"""graph/factors and graph/solver (window solve, dense full-graph
linearization, solve and marginal covariance) of the port against the JAX
package.  Jacobians come from torch.func.jacfwd and jax.jacfwd; both run in
float32, so values agree to float32 rounding (errors are Log maps of
near-identity transforms)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import n, t
from lio_slam_tpu.graph import factors as JF
from lio_slam_tpu.graph import solver as JS
from lio_slam_tpu_torch.graph import factors as TF
from lio_slam_tpu_torch.graph import solver as TS


def chain_graph(K=10, B=12, G=4, count=8, seed=0, with_gps=True):
    """A noisy odometry chain over `count` keyframes with one loop factor
    and a few GPS factors, as numpy leaves."""
    rs = np.random.RandomState(seed)
    truth = np.zeros((K, 6), np.float32)
    truth[:count, 2] = np.cumsum(rs.uniform(0, 0.1, count))
    truth[:count, 3] = np.cumsum(rs.uniform(0.5, 1.0, count))
    truth[:count, 4] = np.cumsum(rs.uniform(-0.2, 0.2, count))
    poses = truth + (rs.randn(K, 6) * [0.01, 0.01, 0.01, 0.05, 0.05, 0.05]
                     ).astype(np.float32) * (np.arange(K) < count)[:, None]
    g = dict(poses=poses.astype(np.float32),
             pose_mask=np.arange(K) < count,
             prior_pose=truth[0],
             prior_info=np.array([100, 100, 0.1, 1e-8, 1e-8, 1e-8], np.float32),
             bt_i=np.zeros(B, np.int32), bt_j=np.zeros(B, np.int32),
             bt_meas=np.zeros((B, 6), np.float32),
             bt_info=np.zeros((B, 6), np.float32), bt_mask=np.zeros(B, bool),
             gps_i=np.zeros(G, np.int32), gps_meas=np.zeros((G, 3), np.float32),
             gps_info=np.zeros((G, 3), np.float32), gps_mask=np.zeros(G, bool))
    pairs = [(i, i + 1) for i in range(count - 1)] + [(0, count - 1)]
    for s, (i, j) in enumerate(pairs):
        meas = np.asarray(JF.se3.pose6_between(jnp.asarray(truth[i]),
                                               jnp.asarray(truth[j])))
        g["bt_i"][s], g["bt_j"][s] = i, j
        g["bt_meas"][s] = meas + rs.randn(6).astype(np.float32) * 1e-3
        g["bt_info"][s] = [1e6, 1e6, 1e6, 1e4, 1e4, 1e4]
        g["bt_mask"][s] = True
    if with_gps:
        for s, i in enumerate([2, 5]):
            g["gps_i"][s] = i
            g["gps_meas"][s] = truth[i, 3:] + rs.randn(3) * 0.1
            g["gps_info"][s] = [1.0, 1.0, 0.5]
            g["gps_mask"][s] = True
    return g


def both_graphs(g):
    return (JF.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()}),
            TF.PoseGraph(**{k: t(v) for k, v in g.items()}))


def test_linearizations_match():
    ja, tb = both_graphs(chain_graph())
    for a, b in zip(jax.jit(JF.linearize_prior)(ja), TF.linearize_prior(tb)):
        np.testing.assert_allclose(n(b), n(a), atol=2e-5)
    for a, b in zip(jax.jit(JF.linearize_between)(ja), TF.linearize_between(tb)):
        np.testing.assert_allclose(n(b), n(a), atol=2e-4)
    for a, b in zip(jax.jit(JF.linearize_gps)(ja), TF.linearize_gps(tb)):
        np.testing.assert_allclose(n(b), n(a), atol=2e-5)
    J = n(TF.linearize_between(tb)[1])
    assert J.dtype == np.float32 and J.shape == (12, 6, 6)


def test_graph_chi2_matches():
    ja, tb = both_graphs(chain_graph(seed=1))
    np.testing.assert_allclose(float(TF.graph_chi2(tb)), float(jax.jit(JF.graph_chi2)(ja)),
                               rtol=1e-4)


def test_info_from_variances():
    v = (1e-2, 1e-2, np.pi * np.pi, 1e8, 1e8, 0.0)
    np.testing.assert_array_equal(n(TF.info_from_variances(v)),
                                  n(JF.info_from_variances(v)))


@pytest.mark.parametrize("count,window,gps", [(8, 4, True), (6, 8, False),
                                              (10, 10, True)])
def test_solve_window_compact_matches(count, window, gps):
    ja, tb = both_graphs(chain_graph(count=count, seed=count, with_gps=gps))
    ga = JS.solve_window_compact(ja, jnp.int32(count), window, iterations=2)
    gb = TS.solve_window_compact(tb, t(np.int32(count)), window, iterations=2)
    # 1e-3: with keyframe 0 in the window the prior's 1e-8 translation
    # information leaves the float32 system near-singular (condition
    # ~1e12 before equilibration), so rounding moves the solution by 1e-4
    np.testing.assert_allclose(n(gb.poses), n(ga.poses), atol=1e-3)
    before = n(tb.poses)
    assert np.abs(n(gb.poses) - before).max() > 1e-4     # the solve moved poses
    untouched = np.arange(10) >= count
    np.testing.assert_array_equal(n(gb.poses)[untouched], before[untouched])


def test_window_mask():
    mask = np.arange(10) < 7
    np.testing.assert_array_equal(
        n(TS.window_mask(t(mask), t(np.int32(7)), 3)),
        n(JS.window_mask(jnp.asarray(mask), jnp.int32(7), 3)))


@pytest.mark.parametrize("seed,gps", [(0, True), (3, False)])
def test_linearize_full_matches(seed, gps):
    """The dense normal equations, the loop factor and the GPS factors
    included: every block within 1e-5 of the largest entry."""
    ja, tb = both_graphs(chain_graph(seed=seed, with_gps=gps))
    Ha, ba, ca = jax.jit(JS.linearize_full)(ja, ja.pose_mask)
    Hb, bb, cb = TS.linearize_full(tb, tb.pose_mask)
    assert Hb.shape == (60, 60) and bb.shape == (60,)
    np.testing.assert_allclose(n(Hb), n(Ha), atol=1e-5 * np.abs(n(Ha)).max())
    np.testing.assert_allclose(n(bb), n(ba), atol=1e-5 * np.abs(n(ba)).max())
    np.testing.assert_allclose(float(cb), float(ca), rtol=1e-4)
    np.testing.assert_allclose(n(Hb), n(Hb).T, atol=1e-6 * np.abs(n(Hb)).max())
    # inactive poses (8, 9): identity diagonal, nothing coupled, zero gradient
    np.testing.assert_allclose(n(Hb)[48:, 48:], np.eye(12) * (1 + 1e-5), atol=1e-7)
    assert not n(Hb)[:48, 48:].any() and not n(bb)[48:].any()


def test_dense_solve_and_marginal_covariance_match():
    """1e-3 on poses as for the window solve (the same near-singular prior);
    covariance blocks within 2e-3 of their largest entry."""
    import torch

    ja, tb = both_graphs(chain_graph(seed=5))
    ra = JS.solve(ja, ja.pose_mask, iterations=3)
    rb = TS.solve(tb, tb.pose_mask, iterations=3)
    np.testing.assert_allclose(n(rb.graph.poses), n(ra.graph.poses), atol=1e-3)
    assert float(TF.graph_chi2(rb.graph)) < float(TF.graph_chi2(tb))
    np.testing.assert_array_equal(n(rb.graph.poses)[8:], n(tb.poses)[8:])
    for idx in (0, 4, 7):
        ca = n(JS.marginal_covariance(ja, jnp.int32(idx)))
        cb = n(TS.marginal_covariance(tb, torch.tensor(idx)))
        np.testing.assert_allclose(cb, ca, atol=2e-3 * np.abs(ca).max())
        np.testing.assert_allclose(cb, cb.T, atol=1e-6 * np.abs(cb).max())
