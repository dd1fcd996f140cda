"""The port's sharded registration, k-NN and graph solver
(`lio_slam_tpu_torch/parallel/`) on 4 gloo ranks, against the JAX package's
on a 4-device virtual CPU mesh (tests/test_sharding.py's cases at D=4) and
against the port's single-device functions.

The ranks (tests/torch_dist_workers.py) run every case of this file in one
spawn; the JAX side runs here meanwhile."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import test_sharding as jt
import torch_port_helpers as H
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.parallel import mesh as jax_mesh
from lio_slam_tpu.parallel import registration as jax_preg
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch.graph import factors as PF
from lio_slam_tpu_torch.graph import solver as port_solver
from lio_slam_tpu_torch.ops import knn as port_knn
from lio_slam_tpu_torch.ops import registration as port_reg

D = 4
INIT_OFFSET = np.array([0.02, 0.01, -0.03, 0.2, -0.15, 0.08], np.float32)


def reg_cfgs(**kw):
    """(port RegistrationConfig, JAX RegistrationConfig) with `kw`."""
    return (port_config.RegistrationConfig(**kw),
            jax_config.RegistrationConfig(**kw))


def problem(**kw):
    """tests/test_sharding.py's `make_problem` as numpy."""
    scan, smask, mp, mmask, true_pose = jt.make_problem(**kw)
    return tuple(np.asarray(x) for x in (scan, smask, mp, mmask, true_pose))


def sequence_problem():
    """The 3-step sequence of test_map_sharded_register_mission_sequence:
    the scans and their truths, made as the JAX test makes them."""
    from lio_slam_tpu.utils import se3

    n_scan, n_map = 512, 8192
    scan0, smask, mp, mmask, true0 = jt.make_problem(n_scan=n_scan,
                                                     n_map=n_map)
    rs = np.random.RandomState(3)
    scans, truths = [], []
    for step in range(3):
        true_pose = true0 + jnp.asarray(
            np.concatenate([rs.randn(3) * 0.01, rs.randn(3) * 0.1])
            .astype(np.float32)) * step
        R, t = se3.pose6_to_Rt(true_pose)
        Ri, ti = se3.inverse(R, t)
        scans.append(np.asarray(se3.transform_points(
            Ri, ti, mp[rs.choice(n_map, n_scan, replace=False)])))
        truths.append(np.asarray(true_pose))
    init0 = np.asarray(true0) + np.array([0.01, 0.0, -0.02, 0.1, -0.1, 0.05],
                                         np.float32)
    return (np.stack(scans), np.asarray(smask), np.asarray(mp),
            np.asarray(mmask), init0, np.stack(truths))


def solver_graph():
    """The 10-pose chain of test_sharded_graph_solver_matches_single as the
    JAX PoseGraph."""
    from lio_slam_tpu.graph import factors as F
    from lio_slam_tpu.utils import se3

    rs = np.random.RandomState(0)
    true = [np.zeros(6, np.float32)]
    for _ in range(9):
        d = np.array([0.01, -0.01, 0.1, 1.0, 0.2, 0.0], np.float32)
        true.append(np.asarray(se3.pose6_compose(jnp.asarray(true[-1]),
                                                 jnp.asarray(d))))
    true = jnp.asarray(np.stack(true))
    noisy = true + jnp.asarray(rs.randn(10, 6).astype(np.float32) * 0.05)
    noisy = noisy.at[0].set(true[0])
    g = F.empty_graph(16, 32, 8)
    g = g._replace(poses=g.poses.at[:10].set(noisy),
                   pose_mask=g.pose_mask.at[:10].set(True),
                   prior_pose=true[0],
                   prior_info=F.info_from_variances([1e-4] * 6))
    info = F.info_from_variances([1e-6] * 3 + [1e-4] * 3)
    for i in range(9):
        meas = se3.pose6_between(true[i], true[i + 1])
        g = g._replace(bt_i=g.bt_i.at[i].set(i), bt_j=g.bt_j.at[i].set(i + 1),
                       bt_meas=g.bt_meas.at[i].set(meas),
                       bt_info=g.bt_info.at[i].set(info),
                       bt_mask=g.bt_mask.at[i].set(True))
    return g


def graph_arrays(g) -> dict:
    return {f: np.asarray(getattr(g, f)) for f in g._fields}


CAPACITY_CFG = dict(degeneracy_eig_thresh=1.0, grid_table_size=1024,
                    grid_max_per_cell=8)
SEQUENCE_CFG = dict(degeneracy_eig_thresh=1.0, grid_table_size=2048,
                    grid_max_per_cell=8)


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(1)
    knn = (rs.randn(256, 3).astype(np.float32), np.ones(256, bool),
           rs.randn(2048, 3).astype(np.float32), np.ones(2048, bool))
    return {"base": problem(), "capacity": problem(n_scan=1024, n_map=16384),
            "sequence": sequence_problem(), "knn": knn,
            "graph": solver_graph()}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    scan, smask, mp, mmask, truth = inputs["base"]
    cscan, csmask, cmp, cmmask, ctruth = inputs["capacity"]
    sscans, ssmask, smp, smmask, init0, _ = inputs["sequence"]
    q, qm, r, rm = inputs["knn"]
    cases = [
        ("sharded_register", D, dict(
            scan=scan, smask=smask, map_pts=mp, map_mask=mmask,
            init=truth + INIT_OFFSET,
            reg_cfg=reg_cfgs(degeneracy_eig_thresh=1.0)[0])),
        ("sharded_knn", D, dict(query=q, query_mask=qm, ref=r, ref_mask=rm,
                                k=5)),
        ("graph_solver", D, dict(graph=graph_arrays(inputs["graph"]),
                                 iterations=3)),
        ("map_sharded_register", D, dict(
            scan=cscan, smask=csmask, map_pts=cmp, map_mask=cmmask,
            init=ctruth + INIT_OFFSET,
            reg_cfg=reg_cfgs(**CAPACITY_CFG)[0])),
        ("map_sharded_sequence", D, dict(
            scans=sscans, smask=ssmask, map_pts=smp, map_mask=smmask,
            init0=init0, reg_cfg=reg_cfgs(**SEQUENCE_CFG)[0])),
    ]
    run = H.spawn_ranks(D, tmp_path_factory.mktemp("sharding_ranks"), cases)
    yield run
    run.close()


@pytest.fixture(scope="module")
def jax_mesh4():
    return jax_mesh.make_mesh(D)


def _one(run, case):
    """Rank 0's results, after checking every rank returned the same."""
    res = H.rank_results(run, case)
    for other in res[1:]:
        for k, v in res[0].items():
            np.testing.assert_array_equal(np.asarray(other[k]), np.asarray(v))
    return res[0]


def test_sharded_register_matches_jax_sharded(ranks, inputs, jax_mesh4):
    scan, smask, mp, mmask, truth = inputs["base"]
    init = truth + INIT_OFFSET
    ref = jax_preg.make_sharded_register(
        jax_mesh4, reg_cfgs(degeneracy_eig_thresh=1.0)[1])(
        jax_mesh.shard_points(jax_mesh4, jnp.asarray(scan)),
        jax_mesh.shard_points(jax_mesh4, jnp.asarray(smask)),
        jnp.asarray(mp), jnp.asarray(mmask), jnp.asarray(init))
    got = _one(ranks, "sharded_register")
    assert np.abs(got["pose"] - truth).max() < 0.02
    np.testing.assert_allclose(got["pose"], np.asarray(ref.pose), atol=1e-4)
    assert got["iterations"] == int(ref.iterations)


def test_sharded_register_matches_port_single_device(ranks, inputs):
    scan, smask, mp, mmask, truth = inputs["base"]
    cfg = reg_cfgs(degeneracy_eig_thresh=1.0)[0]
    ref = port_reg.register(H.t(scan), H.t(smask), H.t(mp), H.t(mmask),
                            H.t(truth + INIT_OFFSET), cfg)
    got = _one(ranks, "sharded_register")
    np.testing.assert_allclose(got["pose"], H.n(ref.pose), atol=5e-3)


def test_sharded_knn_matches_single(ranks, inputs, jax_mesh4):
    """Against the port's exact k-NN and JAX's sharded one: distances
    rtol 1e-4, index sets equal on at least 99 % of the queries."""
    q, qm, r, rm = inputs["knn"]
    got = _one(ranks, "sharded_knn")
    ref = port_knn.knn(H.t(q), H.t(qm), H.t(r), H.t(rm), k=5)
    jd, ji = jax_preg.make_sharded_knn(jax_mesh4, k=5)(
        jnp.asarray(q), jnp.asarray(qm),
        jax_mesh.shard_points(jax_mesh4, jnp.asarray(r)),
        jax_mesh.shard_points(jax_mesh4, jnp.asarray(rm)))
    for d_ref, i_ref in ((H.n(ref.dist2), H.n(ref.idx)),
                         (np.asarray(jd), np.asarray(ji))):
        np.testing.assert_allclose(np.sort(got["dist2"], axis=1),
                                   np.sort(d_ref, axis=1), rtol=1e-4,
                                   atol=1e-5)
        same = [set(a) == set(b) for a, b in zip(got["idx"], i_ref)]
        assert np.mean(same) >= 0.99


def test_sharded_graph_solver_matches_single(ranks, inputs, jax_mesh4):
    from lio_slam_tpu.parallel import graph as jax_pgraph

    g = inputs["graph"]
    got = _one(ranks, "graph_solver")
    ref_jax = jax_pgraph.make_sharded_solver(jax_mesh4)(g, g.pose_mask,
                                                        iterations=3)
    pg = PF.PoseGraph(**{k: H.t(v) for k, v in graph_arrays(g).items()})
    ref_port = port_solver.solve(pg, pg.pose_mask, iterations=3).graph
    np.testing.assert_allclose(got["poses"][:10],
                               np.asarray(ref_jax.poses[:10]), atol=2e-4)
    np.testing.assert_allclose(got["poses"][:10], H.n(ref_port.poses[:10]),
                               atol=2e-4)
    np.testing.assert_array_equal(got["pose_mask"], np.asarray(g.pose_mask))


def test_map_sharded_register_capacity_beyond_one_device(ranks, inputs,
                                                         jax_mesh4):
    """Each rank's grid (1024 buckets x 8) holds a quarter of the 16384-point
    map; the merged 5-NN must reproduce the full-capacity single-device
    register and the JAX map-sharded one."""
    scan, smask, mp, mmask, truth = inputs["capacity"]
    init = truth + INIT_OFFSET
    got = _one(ranks, "map_sharded_register")
    assert np.abs(got["pose"] - truth).max() < 0.02
    port_cfg, jax_cfg = reg_cfgs(**CAPACITY_CFG)
    ref = jax_preg.make_map_sharded_register(jax_mesh4, jax_cfg)(
        jnp.asarray(scan), jnp.asarray(smask),
        jax_mesh.shard_points(jax_mesh4, jnp.asarray(mp)),
        jax_mesh.shard_points(jax_mesh4, jnp.asarray(mmask)),
        jnp.asarray(init))
    np.testing.assert_allclose(got["pose"], np.asarray(ref.pose), atol=1e-4)
    assert got["iterations"] == int(ref.iterations)
    oracle = port_reg.register(
        H.t(scan), H.t(smask), H.t(mp), H.t(mmask), H.t(init),
        dataclasses.replace(port_cfg, grid_table_size=16384,
                            grid_max_per_cell=24))
    np.testing.assert_allclose(got["pose"], H.n(oracle.pose), atol=5e-3)


def test_map_sharded_register_mission_sequence(ranks, inputs, jax_mesh4):
    scans, smask, mp, mmask, init0, truths = inputs["sequence"]
    got = _one(ranks, "map_sharded_sequence")["poses"]
    register = jax_preg.make_map_sharded_register(
        jax_mesh4, reg_cfgs(**SEQUENCE_CFG)[1])
    mp_sh = jax_mesh.shard_points(jax_mesh4, jnp.asarray(mp))
    mm_sh = jax_mesh.shard_points(jax_mesh4, jnp.asarray(mmask))
    pose = jnp.asarray(init0)
    for step in range(3):
        pose = register(jnp.asarray(scans[step]), jnp.asarray(smask), mp_sh,
                        mm_sh, pose).pose
        assert np.abs(got[step] - truths[step]).max() < 0.03, step
        np.testing.assert_allclose(got[step], np.asarray(pose), atol=1e-4)


_TORCHRUN_LIKE = """
import torch
from lio_slam_tpu_torch.graph import factors as F
from lio_slam_tpu_torch.parallel import mesh as m
mesh = m.make_mesh(device_type="cpu")          # the group from the environment
try:
    m.make_mesh(2, device_type="cpu")
    raise SystemExit("n_devices != world size did not raise")
except ValueError:
    pass
g = m.replicate(mesh, F.empty_graph(4, 5, 2))
assert type(g) is F.PoseGraph and g.poses.device.type == "cpu"
x = torch.arange(6.0).reshape(3, 2)
assert m.psum(x, mesh).equal(x) and m.all_gather(x, mesh).shape == (1, 3, 2)
assert m.shard_points(mesh, x).equal(x) and m.gather_sharded(x, mesh).equal(x)
print(m.axis_size(mesh), m.axis_index(mesh), mesh.mesh_dim_names)
"""


def test_make_mesh_from_torchrun_environment():
    """`make_mesh` with no process group initializes one from torchrun's
    variables (a world of one here), refuses a device count other than the
    world size, and the helpers are identities on one rank."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, RANK="0", LOCAL_RANK="0",
               WORLD_SIZE="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _TORCHRUN_LIKE], cwd=root,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "1 0 ('data',)"
