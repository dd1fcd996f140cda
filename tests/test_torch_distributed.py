"""The port's multi-process rendezvous (`lio_slam_tpu_torch/parallel/
distributed.py`): the twin of tests/test_distributed.py.

Four processes join through `distributed.initialize` from the LIO_*
variables (a TCP store served by process 0), as two hosts of two ranks
(LOCAL_WORLD_SIZE=2), so `global_mesh()` is ("slice", "data") = (2, 2)
with the "slice" axis across the host boundary.  The ranks
(tests/torch_dist_workers.py, no jax) run every case in one spawn; the JAX
references run here meanwhile on the same numpy inputs."""

import numpy as np
import pytest

import torch_port_helpers as H
from dist_fixtures import make_register_fixture
from graph_fixtures import make_chain_fixture, make_loop_graph_fixture
from lio_slam_tpu.graph import solver
from lio_slam_tpu.graph import sparse as jax_sparse
from lio_slam_tpu_torch.config import RegistrationConfig
from lio_slam_tpu_torch.parallel import distributed as pdist

WORLD = 4
LOCAL_WORLD_SIZE = 2
DEADLINE_S = 120.0
SPARSE_K = 256          # K = 2048 runs on the card (chip_smoke.py phase 18)


def arrays(g) -> dict:
    return {f: np.asarray(getattr(g, f)) for f in g._fields}


@pytest.fixture(scope="module")
def inputs():
    return {"chain": make_chain_fixture(),
            "register": make_register_fixture(),
            "sparse": make_loop_graph_fixture(K=SPARSE_K, n_loops=8)}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    g, _ = inputs["chain"]
    world, scan, _ = inputs["register"]
    g2, _ = inputs["sparse"]
    scene = dict(scan=scan, smask=np.ones(scan.shape[0], bool),
                 map_pts=world, map_mask=np.ones(world.shape[0], bool),
                 init=np.zeros(6, np.float32))
    cases = [
        ("mesh", "global", dict(case="multislice_mesh")),
        ("chain", "global", dict(case="multislice_solver", graph=arrays(g),
                                 iterations=3)),
        ("register", "global", dict(
            case="multislice_register", reg_cfg=RegistrationConfig(
                max_iterations=10, degeneracy_eig_thresh=1.0), **scene)),
        ("sparse", "global", dict(case="sparse_solve", graph=arrays(g2),
                                  iterations=8, axes=("slice", "data"))),
        ("map_sharded", "global", dict(
            case="map_sharded_register", axis="slice",
            reg_cfg=RegistrationConfig(max_iterations=10,
                                       degeneracy_eig_thresh=1.0,
                                       grid_table_size=2048,
                                       grid_max_per_cell=16), **scene)),
    ]
    run = H.spawn_ranks(WORLD, tmp_path_factory.mktemp("distributed_ranks"),
                        cases, deadline_s=DEADLINE_S,
                        local_world_size=LOCAL_WORLD_SIZE)
    yield run
    run.close()


def _rank0(run, case):
    """Rank 0's results, after checking every rank returned the same."""
    res = H.rank_results(run, case)
    for other in res[1:]:
        for k, v in res[0].items():
            np.testing.assert_array_equal(np.asarray(other[k]), np.asarray(v))
    return res[0]


def test_global_mesh_is_one_slice_a_host(ranks):
    """Four processes of two a host: ("slice", "data") = (2, 2), each
    process the rank LIO_PROCESS_ID named."""
    res = H.rank_results(ranks, "mesh")
    assert [r["rank"] for r in res] == list(range(WORLD))
    for r in res:
        assert r["names"] == ("slice", "data")
        assert r["shape"] == (WORLD // LOCAL_WORLD_SIZE, LOCAL_WORLD_SIZE)


def test_initialize_names_the_missing_variables(monkeypatch):
    """Without arguments or LIO_* variables, `initialize` raises before it
    joins anything, naming what is missing; nothing is autodetected."""
    for name in pdist.ENV:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError) as e:
        pdist.initialize(device_type="cpu")
    for name in pdist.ENV:
        assert name in str(e.value)
    monkeypatch.setenv("LIO_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("LIO_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="LIO_PROCESS_ID") as e:
        pdist.initialize(device_type="cpu")
    assert "LIO_COORDINATOR" not in str(e.value)


def test_chain_solve_matches_single_process(ranks, inputs):
    """The multislice solver across the processes against JAX's
    `solver.solve` on the chain fixture: within 2e-3."""
    g, n = inputs["chain"]
    got = _rank0(ranks, "chain")["poses"]
    ref = solver.solve(g, g.pose_mask, iterations=3).graph
    np.testing.assert_allclose(got[:n], np.asarray(ref.poses[:n]), atol=2e-3)


def test_register_recovers_the_pose(ranks, inputs):
    """The scan placed by `factor_sharded` (128 points a process), the map
    by `replicated`: within 0.02 of the fixture's pose."""
    _, scan, true_pose = inputs["register"]
    got = _rank0(ranks, "register")
    assert got["shard_rows"] == scan.shape[0] // WORLD
    np.testing.assert_allclose(got["pose"], true_pose, atol=0.02)


def test_factor_sharded_sparse_solve_matches_single_process(ranks, inputs):
    """The sparse solve with the Woodbury columns over both axes, at
    K = 256 with 8 loop factors: within 5e-2 of JAX's `solve_sparse` and
    converging on the truth."""
    g2, truth = inputs["sparse"]
    got = _rank0(ranks, "sparse")["poses"]
    ref = np.asarray(jax_sparse.solve_sparse(g2, iterations=8).graph.poses)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=5e-2)
    assert np.abs(got - truth).max() < 0.5


def test_map_sharded_register_across_the_hosts(ranks, inputs):
    """The map split over "slice", that is across the host boundary (each
    host's grid holds half of it): within 0.02 of the pose, with more than
    100 inliers."""
    _, _, true_pose = inputs["register"]
    got = _rank0(ranks, "map_sharded")
    np.testing.assert_allclose(got["pose"], true_pose, atol=0.02)
    assert got["num_inliers"] > 100
