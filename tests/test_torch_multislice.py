"""The port's two-level ("slice", "data") mesh
(`lio_slam_tpu_torch/parallel/multislice.py`) on 4 gloo ranks at (2, 2),
against the JAX package's on its 8-device virtual CPU mesh at (2, 4):
tests/test_multislice.py's four cases.

The ranks (tests/torch_dist_workers.py) run every case of this file in one
spawn; the JAX side runs here meanwhile."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_multislice as jt
import torch_port_helpers as H
from dist_fixtures import make_register_fixture
from lio_slam_tpu.config import RegistrationConfig as JaxRegistrationConfig
from lio_slam_tpu.graph import solver
from lio_slam_tpu.parallel import multislice as jax_ms
from lio_slam_tpu_torch.config import RegistrationConfig

SHAPE = (2, 2)
REG_KW = dict(max_iterations=10, degeneracy_eig_thresh=1.0)


def arrays(g) -> dict:
    return {f: np.asarray(getattr(g, f)) for f in g._fields}


@pytest.fixture(scope="module")
def inputs():
    g, true = jt.chain_graph()
    return {"chain": (g, np.asarray(true)),
            "register": make_register_fixture()}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    g, _ = inputs["chain"]
    world, scan, _ = inputs["register"]
    cases = [
        ("mesh", SHAPE, dict(case="multislice_mesh")),
        ("solver", SHAPE, dict(case="multislice_solver", graph=arrays(g),
                               iterations=3)),
        ("register", SHAPE, dict(
            case="multislice_register", scan=scan,
            smask=np.ones(scan.shape[0], bool), map_pts=world,
            map_mask=np.ones(world.shape[0], bool),
            init=np.zeros(6, np.float32),
            reg_cfg=RegistrationConfig(**REG_KW))),
        ("psum", SHAPE, dict(case="psum_staged",
                             x=np.arange(8.0, dtype=np.float32))),
    ]
    run = H.spawn_ranks(4, tmp_path_factory.mktemp("multislice_ranks"), cases)
    yield run
    run.close()


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) >= 8
    return jax_ms.make_multislice_mesh(2, 4)


def _same_on_every_rank(run, case):
    res = H.rank_results(run, case)
    for other in res[1:]:
        for k, v in res[0].items():
            np.testing.assert_array_equal(np.asarray(other[k]), np.asarray(v))
    return res[0]


def test_multislice_mesh_axes(ranks):
    """("slice", "data") at (2, 2), rank s * 2 + d at (s, d); a mesh of
    another size than the group, and factor rows that do not divide by the
    mesh, raise."""
    res = H.rank_results(ranks, "mesh")
    for r in res:
        assert r["names"] == ("slice", "data")
        assert r["shape"] == SHAPE
        wrong_size, not_dividing = r["errors"]
        assert wrong_size is not None and "(2, 4)" in wrong_size
        assert not_dividing is not None and "does not divide" in not_dividing
    assert [r["rank"] for r in res] == [0, 1, 2, 3]


def test_multislice_solver_matches_reference(ranks, inputs, jax_mesh):
    """Within 1e-4 of JAX's multislice solver and of the dense
    `solver.solve`, and at least halving the largest error to the truth;
    the caller's pose mask comes back."""
    g, true = inputs["chain"]
    active = np.asarray(g.pose_mask)
    got = _same_on_every_rank(ranks, "solver")
    ref = solver.solve(g, g.pose_mask, iterations=3).graph
    ref_ms = jax_ms.make_multislice_solver(jax_mesh)(g, g.pose_mask,
                                                     iterations=3)
    for want in (ref.poses, ref_ms.poses):
        np.testing.assert_allclose(got["poses"][active],
                                   np.asarray(want)[active],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got["pose_mask"], active)
    err0 = np.abs(np.asarray(g.poses) - true)[active].max()
    err1 = np.abs(got["poses"] - true)[active].max()
    assert err1 < err0 * 0.5


def test_multislice_register_converges(ranks, inputs, jax_mesh):
    """The scan sharded over both axes (128 points a rank): within 0.02 of
    the true pose, and within 1e-4 of JAX's multislice register with equal
    iterations, `degenerate` and `converged` (JAX returns zeros for the
    inliers and the residual, so those are not compared)."""
    world, scan, true_pose = inputs["register"]
    got = _same_on_every_rank(ranks, "register")
    assert got["shard_rows"] == scan.shape[0] // 4
    np.testing.assert_allclose(got["pose"], true_pose, atol=0.02)
    ref = jax_ms.make_multislice_register(
        jax_mesh, JaxRegistrationConfig(**REG_KW))(
        jnp.asarray(scan), jnp.ones(scan.shape[0], bool), jnp.asarray(world),
        jnp.ones(world.shape[0], bool), jnp.zeros(6))
    np.testing.assert_allclose(got["pose"], np.asarray(ref.pose), atol=1e-4)
    assert got["iterations"] == int(ref.iterations)
    assert got["degenerate"] == bool(ref.degenerate)
    assert got["converged"] == bool(ref.converged)
    assert got["num_inliers"] > 100


def test_psum_staged_equals_full_psum(ranks):
    """Each rank's two rows of arange(8), reduced over "data" and then
    "slice", equal one all_reduce over the whole group: 28."""
    for r in H.rank_results(ranks, "psum"):
        assert r["staged"] == r["flat"] == 28.0
