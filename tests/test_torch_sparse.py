"""graph/sparse (block-tridiagonal + Woodbury) and the dense full-graph
solve of the port against the JAX package, on the graphs of
tests/graph_fixtures.py and tests/test_sparse_solver.py.

Tolerances: the port against the JAX function of the same name within 1e-3
(m and rad; both solve a float32 system whose noise models span 14 orders of
magnitude, measured 4e-5), chi2 within 1e-3 relative (or 1e-4 absolute: at
convergence the chain's chi2 is 4e-6, rounding alone); sparse against dense
inside the port within the JAX package's own 2e-3 / 5e-3; marginal
covariances within 2e-3 relative to the block's largest entry against JAX
and rtol 0.15 sparse against dense, as in JAX.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t
from lio_slam_tpu.graph import factors as JF
from lio_slam_tpu.graph import solver as JS
from lio_slam_tpu.graph import sparse as JSP
from lio_slam_tpu.utils import se3 as jse3
from lio_slam_tpu_torch.graph import factors as TF
from lio_slam_tpu_torch.graph import solver as TS
from lio_slam_tpu_torch.graph import sparse as TSP

from tests.graph_fixtures import make_chain_fixture


def to_torch(g):
    return TF.PoseGraph(*(t(np.array(x)) for x in g))


def add_loop(g, i, j, info_scale=1e2):
    """A loop between keyframes i and j in the first free loop-region slot
    (slots >= K-1, the layout of pipeline/lio.py)."""
    slot = g.poses.shape[0] - 1
    while bool(g.bt_mask[slot]):
        slot += 1
    return g._replace(
        bt_i=g.bt_i.at[slot].set(i), bt_j=g.bt_j.at[slot].set(j),
        bt_meas=g.bt_meas.at[slot].set(jse3.pose6_between(g.poses[i],
                                                          g.poses[j])),
        bt_info=g.bt_info.at[slot].set(jnp.full(6, info_scale)),
        bt_mask=g.bt_mask.at[slot].set(True))


@functools.lru_cache(maxsize=None)
def graph_case(name):
    g, count = make_chain_fixture(n=24, K=32, B=64, G=16, seed=42)
    if name == "loops":
        g = add_loop(add_loop(g, 2, 20), 5, 22)
    elif name == "disagreeing_loop":
        g = add_loop(g._replace(poses=g.poses.at[20, 3].add(0.3)), 2, 20)
    return g, count


CASES = [("chain", 3, 2e-3), ("loops", 4, 5e-3), ("disagreeing_loop", 5, 5e-3)]


@pytest.mark.parametrize("name,iterations,atol", CASES)
def test_dense_solve_matches_jax(name, iterations, atol):
    g, count = graph_case(name)
    ref = JS.solve(g, g.pose_mask, iterations=iterations)
    got = TS.solve(to_torch(g), t(np.array(g.pose_mask)), iterations=iterations)
    np.testing.assert_allclose(n(got.graph.poses), n(ref.graph.poses), atol=1e-3)
    np.testing.assert_allclose(float(got.chi2), float(ref.chi2), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(float(got.delta_norm), float(ref.delta_norm),
                               atol=1e-3)
    np.testing.assert_array_equal(n(got.graph.poses)[count:], 0.0)


@pytest.mark.parametrize("name,iterations,atol", CASES)
def test_sparse_solve_matches_jax_and_dense(name, iterations, atol):
    g, count = graph_case(name)
    tg = to_torch(g)
    ref = JSP.solve_sparse(g, iterations=iterations)
    got = TSP.solve_sparse(tg, iterations=iterations)
    np.testing.assert_allclose(n(got.graph.poses), n(ref.graph.poses), atol=1e-3)
    np.testing.assert_allclose(float(got.chi2), float(ref.chi2), rtol=1e-3,
                               atol=1e-4)
    dense = TS.solve(tg, tg.pose_mask, iterations=iterations)
    np.testing.assert_allclose(n(got.graph.poses)[:count],
                               n(dense.graph.poses)[:count], atol=atol)


def test_disagreeing_loop_lowers_chi2():
    g, _ = graph_case("disagreeing_loop")
    tg = to_torch(g)
    before = float(TF.graph_chi2(tg))
    after = float(TF.graph_chi2(TSP.solve_sparse(tg, iterations=5).graph))
    assert after < 0.5 * before, (before, after)
    assert abs(float(n(tg.poses)[20, 3])
               - float(n(TSP.solve_sparse(tg, iterations=5).graph.poses)[20, 3])) > 0.1


@pytest.mark.parametrize("name", ["chain", "loops"])
def test_active_prefix_recursion_equals_full_length(name):
    """The recursion over the active prefix (24 of 32 blocks, read from the
    mask) and the full-length one the JAX package runs give the same bits:
    the tail blocks are identity, coupled to nothing."""
    g, count = graph_case(name)
    tg = to_torch(g)
    assert int(TSP.active_prefix_len(tg.pose_mask)) == count
    short = TSP.solve_sparse(tg, iterations=3)
    given = TSP.solve_sparse(tg, iterations=3, n_active=count)
    full = TSP.solve_sparse(tg, iterations=3, n_active=32)
    np.testing.assert_array_equal(n(short.graph.poses), n(full.graph.poses))
    np.testing.assert_array_equal(n(given.graph.poses), n(full.graph.poses))
    for idx in (0, count - 1):
        np.testing.assert_array_equal(
            n(TSP.marginal_covariance_sparse(tg, torch.tensor(idx))),
            n(TSP.marginal_covariance_sparse(tg, torch.tensor(idx), n_active=32)))
    D, Loff, b, _, _ = TSP._assemble(tg)
    f_short, f_full = TSP.tridiag_factor(D, Loff, count), TSP.tridiag_factor(D, Loff)
    np.testing.assert_array_equal(n(f_short.chols), n(f_full.chols))
    np.testing.assert_array_equal(n(TSP.tridiag_solve(f_short, b)),
                                  n(TSP.tridiag_solve(f_full, b)))


def test_tridiag_factor_and_solve_match_jax():
    g, _ = graph_case("chain")
    Dj, Lj, bj, chi_j = jax.jit(lambda g: JSP._assemble(g)[:4])(g)
    Dt, Lt, bt, chi_t, _ = TSP._assemble(to_torch(g))
    scale = np.abs(n(Dj)).max()
    np.testing.assert_allclose(n(Dt), n(Dj), atol=1e-5 * scale)
    np.testing.assert_allclose(n(Lt), n(Lj), atol=1e-5 * scale)
    np.testing.assert_allclose(n(bt), n(bj), atol=1e-5 * np.abs(n(bj)).max())
    np.testing.assert_allclose(float(chi_t), float(chi_j), rtol=1e-4)
    xj = jax.jit(lambda D, L, b: JSP.tridiag_solve(JSP.tridiag_factor(D, L), b))(
        Dj, Lj, bj)
    xt = TSP.tridiag_solve(TSP.tridiag_factor(t(n(Dj)), t(n(Lj))), t(n(bj)))
    np.testing.assert_allclose(n(xt), n(xj), atol=1e-4)
    # a dense solve of the same tridiagonal system
    K = Dt.shape[0]
    T = torch.zeros(K, 6, K, 6, dtype=torch.float64)
    for i in range(K):
        T[i, :, i, :] = Dt[i].double()
        if i + 1 < K:
            T[i + 1, :, i, :] = Lt[i].double()
            T[i, :, i + 1, :] = Lt[i].double().T
    x = torch.linalg.solve(T.reshape(K * 6, K * 6), bt.double().reshape(-1))
    np.testing.assert_allclose(n(xt).reshape(-1), n(x), atol=2e-3)


@pytest.mark.parametrize("name,idx", [("chain", 0), ("chain", 7), ("chain", 23),
                                      ("loops", 20)])
def test_marginal_covariance_matches(name, idx):
    g, _ = graph_case(name)
    tg = to_torch(g)
    cd = n(TS.marginal_covariance(tg, torch.tensor(idx)))
    cs = n(TSP.marginal_covariance_sparse(tg, torch.tensor(idx)))
    jd = n(JS.marginal_covariance(g, jnp.int32(idx)))
    js = n(JSP.marginal_covariance_sparse(g, jnp.int32(idx)))
    np.testing.assert_allclose(cd, jd, atol=2e-3 * np.abs(jd).max())
    np.testing.assert_allclose(cs, js, atol=2e-3 * np.abs(js).max())
    np.testing.assert_allclose(cs, cd, rtol=0.15, atol=1e-6)
    assert cd.shape == (6, 6) and (np.diag(cd) > 0).all()


def test_chain_region_drops_non_chain_topology():
    """A factor routed through the chain region with bt_j != bt_i + 1 is
    dropped, not scattered to the wrong block and not raised on: the solve
    equals the solve without it."""
    g, count = graph_case("chain")
    slot = count + 2                       # inside [0, K-1), masked so far
    bad = g._replace(
        bt_i=g.bt_i.at[slot].set(2), bt_j=g.bt_j.at[slot].set(17),
        bt_meas=g.bt_meas.at[slot].set(jse3.pose6_between(g.poses[2],
                                                          g.poses[17])),
        bt_info=g.bt_info.at[slot].set(jnp.full(6, 1e4)),
        bt_mask=g.bt_mask.at[slot].set(True))
    ref = TSP.solve_sparse(to_torch(g), iterations=3).graph.poses
    got = TSP.solve_sparse(to_torch(bad), iterations=3).graph.poses
    np.testing.assert_allclose(n(got), n(ref), atol=1e-6)


def test_repeated_indices_sum_in_a_fixed_order():
    """Several GPS factors on one pose and masked slots that all name pose 0:
    the sums equal the dense assembly's and two runs give the same bits."""
    g, _ = graph_case("loops")
    g = g._replace(gps_i=g.gps_i.at[3:6].set(12),
                   gps_meas=g.gps_meas.at[3:6].set(g.poses[12, 3:] + 0.05),
                   gps_info=g.gps_info.at[3:6].set(jnp.full(3, 50.0)),
                   gps_mask=g.gps_mask.at[3:6].set(True))
    tg = to_torch(g)
    a = TSP.solve_sparse(tg, iterations=2)
    b = TSP.solve_sparse(tg, iterations=2)
    np.testing.assert_array_equal(n(a.graph.poses), n(b.graph.poses))
    ref = JSP.solve_sparse(g, iterations=2)
    np.testing.assert_allclose(n(a.graph.poses), n(ref.graph.poses), atol=1e-3)
    dense = TS.solve(tg, tg.pose_mask, iterations=2)
    np.testing.assert_allclose(n(a.graph.poses), n(dense.graph.poses), atol=5e-3)


def test_non_spd_block_gives_nan_not_an_exception():
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    assert bool(torch.isnan(TSP._cholesky_or_nan(bad)).all())
    good = torch.eye(2) * 4.0
    np.testing.assert_array_equal(n(TSP._cholesky_or_nan(good)), np.eye(2) * 2.0)


def long_lever_graph(K):
    """The long-lever-arm loop graph of tests/test_sparse_solver.py: a noisy
    straight chain, four loops i <-> i + K/4, a translation-soft prior."""
    rs = np.random.RandomState(0)
    poses = np.zeros((K, 6), np.float32)
    poses[:, 3] = np.arange(K)
    poses += rs.randn(K, 6).astype(np.float32) * 0.02
    B = (K - 1) + 16
    meas = np.tile(np.array([0, 0, 0, 1, 0, 0], np.float32), (B, 1))
    bt_i = np.concatenate([np.arange(K - 1), np.zeros(17, np.int64)])[:B]
    bt_j = np.concatenate([np.arange(1, K), np.zeros(17, np.int64)])[:B]
    bt_mask = np.zeros(B, bool)
    bt_mask[:K - 1] = True
    for q in range(4):
        s = (K - 1) + q
        bt_i[s], bt_j[s] = q * (K // 8), q * (K // 8) + K // 4
        meas[s] = [0, 0, 0, K // 4, 0, 0]
        bt_mask[s] = True
    info = np.tile(n(JF.info_from_variances(
        (1e-6, 1e-6, 1e-6, 1e-4, 1e-4, 1e-4))), (B, 1))
    g = JF.empty_graph(K, B, 16)._replace(
        poses=jnp.asarray(poses), pose_mask=jnp.ones(K, bool),
        prior_pose=jnp.asarray(poses[0]),
        prior_info=JF.info_from_variances(
            (1e-2, 1e-2, np.pi ** 2, 1e8, 1e8, 1e8)),
        bt_i=jnp.asarray(bt_i, jnp.int32), bt_j=jnp.asarray(bt_j, jnp.int32),
        bt_meas=jnp.asarray(meas), bt_info=jnp.asarray(info, jnp.float32),
        bt_mask=jnp.asarray(bt_mask))
    truth = np.zeros((K, 6))
    truth[:, 3] = np.arange(K)
    return g, truth


def test_backtracking_monotone_descent_long_lever_loops():
    """K=512 as in the JAX package's test: without step control the raw GN
    step overshoots and chi2 diverges with more iterations; with it, 20
    iterations end within centimetres of the optimum."""
    g, truth = long_lever_graph(512)
    tg = to_torch(g)
    r5 = TSP.solve_sparse(tg, iterations=5)
    r20 = TSP.solve_sparse(tg, iterations=20)
    d5 = float(np.abs(n(r5.graph.poses) - truth).max())
    d20 = float(np.abs(n(r20.graph.poses) - truth).max())
    assert d20 <= d5 + 1e-4, (d5, d20)
    assert d20 < 0.05, f"not converged: {d20} m from the optimum"
    assert float(TF.graph_chi2(r20.graph)) < 10.0
    j5 = JSP.solve_sparse(g, iterations=5)
    # 2e-2: five steps of a float32 solve over 512 blocks with lever arms of
    # 128 m; both are still ~d5 from the optimum here
    np.testing.assert_allclose(n(r5.graph.poses), n(j5.graph.poses), atol=2e-2)
