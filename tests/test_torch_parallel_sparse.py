"""The port's column-sharded sparse pose-graph solver
(`lio_slam_tpu_torch/parallel/sparse.py`) on 4 gloo ranks, against the JAX
package's on a 4-device virtual CPU mesh and against the port's
single-device `solve_sparse`: tests/test_parallel_sparse.py's cases.

The ranks (tests/torch_dist_workers.py) run every case of this file in one
spawn; the JAX side runs here meanwhile."""

import numpy as np
import pytest

import test_parallel_sparse as jt
import torch_port_helpers as H
from lio_slam_tpu.parallel import mesh as jax_mesh
from lio_slam_tpu.parallel import multislice as jax_ms
from lio_slam_tpu.parallel import sparse as jax_psp
from lio_slam_tpu_torch.graph import factors as PF
from lio_slam_tpu_torch.graph import sparse as port_sp

D = 4


def arrays(g) -> dict:
    return {f: np.asarray(getattr(g, f)) for f in g._fields}


def port_graph(g) -> PF.PoseGraph:
    return PF.PoseGraph(**{k: H.t(v) for k, v in arrays(g).items()})


# case -> (mesh shape, K, loop factors, GN iterations)
CASES = {
    "k64": (D, 64, 8, 3),
    "k256": (D, 256, 8, 3),
    "chain_only": (D, 64, 0, 3),
    "mesh_2x2": ((2, 2), 64, 8, 2),
}


@pytest.fixture(scope="module")
def graphs():
    return {name: jt.make_loop_graph(K, n_loops=loops)
            for name, (_, K, loops, _) in CASES.items()}


@pytest.fixture(scope="module")
def ranks(graphs, tmp_path_factory):
    cases = [(name, shape, dict(case="sparse_solve", graph=arrays(graphs[name]),
                                iterations=it,
                                axes=("data",) if shape == D
                                else ("slice", "data")))
             for name, (shape, _, _, it) in CASES.items()]
    run = H.spawn_ranks(D, tmp_path_factory.mktemp("sparse_ranks"), cases)
    yield run
    run.close()


def check(ranks, graphs, name, jax_solve):
    """The ranks' poses: bit-equal across ranks, within 1e-4 of the JAX
    sharded solver and of the port's single-device solver."""
    it = CASES[name][3]
    g = graphs[name]
    res = H.rank_results(ranks, name)
    got = res[0]["poses"]
    for other in res[1:]:
        np.testing.assert_array_equal(other["poses"], got)
    ref_jax = np.asarray(jax_solve(g, iterations=it).graph.poses)
    ref_port = H.n(port_sp.solve_sparse(port_graph(g), iterations=it)
                   .graph.poses)
    np.testing.assert_allclose(got, ref_jax, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, ref_port, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["k64", "k256"])
def test_sharded_matches_single_device(ranks, graphs, name):
    check(ranks, graphs, name,
          jax_psp.make_sharded_sparse_solver(jax_mesh.make_mesh(D)))


def test_sharded_no_loops_chain_only(ranks, graphs):
    check(ranks, graphs, "chain_only",
          jax_psp.make_sharded_sparse_solver(jax_mesh.make_mesh(D)))


def test_sharded_2d_mesh_staged(ranks, graphs):
    """("slice", "data") = (2, 2) over 4 ranks (the Woodbury columns
    gathered over both axes; JAX also reduces its assembly inner axis
    first): the same numbers within 1e-4.  The JAX mesh comes from
    `make_multislice_mesh(2, 2)`."""
    check(ranks, graphs, "mesh_2x2",
          jax_psp.make_sharded_sparse_solver(jax_ms.make_multislice_mesh(2, 2),
                                             axes=("slice", "data")))


@pytest.mark.slow
def test_sharded_production_k2048(tmp_path):
    """K=2048 on 4 ranks, the JAX slow test's gates against the port's
    single-device solver: chain-only within 1e-4; with loops within 5e-2
    (float32 reduction order in the Woodbury S solve, whose masked loop
    rows carry 1e8) and no farther from the truth than 1.1x + 1e-3."""
    g0 = jt.make_loop_graph(2048, n_loops=0)
    g = jt.make_loop_graph(2048)
    run = H.spawn_ranks(D, tmp_path, [
        ("chain", D, dict(case="sparse_solve", graph=arrays(g0), iterations=2,
                          axes=("data",))),
        ("loops", D, dict(case="sparse_solve", graph=arrays(g), iterations=5,
                          axes=("data",)))], deadline_s=900)
    try:
        got0 = H.rank_results(run, "chain")[0]["poses"]
        got = H.rank_results(run, "loops")[0]["poses"]
    finally:
        run.close()
    ref0 = H.n(port_sp.solve_sparse(port_graph(g0), iterations=2).graph.poses)
    assert np.abs(got0 - ref0).max() < 1e-4
    ref = H.n(port_sp.solve_sparse(port_graph(g), iterations=5).graph.poses)
    assert np.abs(got - ref).max() < 5e-2
    truth = np.zeros((2048, 6), np.float32)
    truth[:, 3] = np.arange(2048)
    d_ref, d_got = np.abs(ref - truth).max(), np.abs(got - truth).max()
    assert d_got <= d_ref * 1.1 + 1e-3, (d_got, d_ref)
