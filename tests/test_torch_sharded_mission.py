"""The port's sharded mission (`lio_slam_tpu_torch/parallel/mission.py`,
`Runner(mesh=...)`) on gloo ranks, against the JAX package's on the virtual
CPU mesh at the same size: tests/test_sharded_mission.py's 12 scans of 2048
points with 512 buckets a shard, at D=2 and D=4.

Each world size is one spawn of tests/torch_dist_workers.py running every
case of this file; the JAX side runs here meanwhile.  The D=2 ranks also
resume from the checkpoint the JAX Runner with a mesh writes here, and this
side loads the one the port's sharded Runner writes.  One D=2 case runs
the mission at halo "xy" against a recorded JAX run."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_helpers as H
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.io import formats as jax_formats
from lio_slam_tpu.io import synthetic
from lio_slam_tpu.parallel import mesh as jax_mesh
from lio_slam_tpu.parallel import mission as jax_pmission
from lio_slam_tpu.pipeline import checkpoint as jax_checkpoint
from lio_slam_tpu.pipeline import lio as jax_lio
from lio_slam_tpu.pipeline.runner import Runner as JaxRunner
from lio_slam_tpu.utils import pointcloud as jpc, se3 as jse3
from lio_slam_tpu_torch import config as port_config

T_LOCAL = 512
N_SCANS = 12
N_CORRECTION = 8        # scans before the injected loop
N_RUNNER = 10           # scans before the checkpoint
DEADLINE_S = 150.0


def mission_config(m, halo="z", cap=8):
    """tests/test_sharded_mission.py's `_cfg(512)` in config module `m`,
    with the sparse full solver so the correction runs the sharded one; at
    another halo layout, `cap` slots a bucket."""
    return m.Config(
        static=m.StaticConfig(max_raw_points=2048, max_scan_points=2048,
                              max_map_points=8192, max_keyframes=16,
                              max_keyframe_points=2048, max_loop_queue=2,
                              max_gps_queue=2, window_size=8,
                              max_imu_window=16, full_solver="sparse"),
        registration=m.RegistrationConfig(grid_table_size=T_LOCAL,
                                          grid_max_per_cell=cap,
                                          grid_halo=halo,
                                          degeneracy_eig_thresh=10.0),
        keyframe=m.KeyframeConfig(dist_threshold=0.2))


PORT_CFG = mission_config(port_config)
JAX_CFG = mission_config(jax_config)
# the mission at a halo layout other than "z": "xy" (3 buckets a query, 9
# rows an insert) at three times the slots, as phase 20's "xy" mission
# holds 72 against "z"'s 24.  Its JAX side is `sharded_halos_jax.npz`'s
# `mission_xy_` keys (`tests/torch_port_make_fixture.py sharded_halos`)
HALO, HALO_CAP = "xy", 24
HALO_FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "lio_slam_tpu_torch", "fixtures",
    "sharded_halos_jax.npz")


def make_seq() -> dict:
    s = synthetic.make_sequence(n_scans=N_SCANS, n_points=2048, seed=0,
                                speed=2.0)
    return {k: np.asarray(getattr(s, k))
            for k in ("scans", "scan_masks", "stamps", "poses")}


@pytest.fixture(scope="module")
def seq():
    return make_seq()


@pytest.fixture(scope="module")
def ckpt_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_ckpt")
    return {"jax": str(d / "jax.npz"), "port": str(d / "port.npz")}


def _spawn(world, cases, tmp_path_factory):
    return H.spawn_ranks(world, tmp_path_factory.mktemp(f"mission_{world}"),
                         cases, deadline_s=DEADLINE_S)


@pytest.fixture(scope="module")
def ranks(seq, ckpt_paths, tmp_path_factory):
    """Both spawns at once; the JAX Runner's checkpoint written here, for
    the D=2 ranks' last case, before anything waits on them."""
    mission = lambda: dict(case="mission", cfg=PORT_CFG, seq=seq,
                           n_scans=N_SCANS)
    runs = {
        2: _spawn(2, [
            ("runner_device", 2, dict(cfg=PORT_CFG)),
            ("mission", 2, mission()),
            ("mission_xy", 2, dict(
                case="mission", cfg=mission_config(port_config, HALO,
                                                   HALO_CAP),
                seq=seq, n_scans=N_SCANS)),
            ("full_correction", 2, dict(cfg=PORT_CFG, seq=seq,
                                        n_scans=N_CORRECTION)),
            ("runner", 2, dict(cfg=PORT_CFG, seq=seq, n_scans=N_RUNNER,
                               ckpt_path=ckpt_paths["port"])),
            ("resume_from", 2, dict(cfg=PORT_CFG, seq=seq,
                                    path=ckpt_paths["jax"], lo=N_RUNNER,
                                    hi=N_SCANS, wait_s=DEADLINE_S))],
            tmp_path_factory),
        4: _spawn(4, [("mission", 4, mission())], tmp_path_factory)}
    try:
        jr = JaxRunner(JAX_CFG, loop_every=6, mesh=jax_mesh.make_mesh(2),
                       fetch_every=2)
        feed(jr, seq, 0, N_RUNNER)
        jr.save_checkpoint(ckpt_paths["jax"])
        before = len(jr.trajectory)
        feed(jr, seq, N_RUNNER, N_SCANS)
        runs["jax_runner"] = (jr, before)
        yield runs
    finally:
        runs[2].close()
        runs[4].close()


def feed(runner, seq, lo, hi):
    for i in range(lo, hi):
        m = seq["scan_masks"][i]
        k = int(m.sum())
        runner.process_scan(jax_formats.StandardScan(
            xyz=seq["scans"][i][m], intensity=np.zeros(k, np.float32),
            ring=np.zeros(k, np.uint16), time=np.zeros(k, np.float32),
            stamp=float(seq["stamps"][i])))
    runner.drain()


def _scan_input(seq, i, guess, gvalid):
    return jax_lio.ScanInput(
        cloud=jpc.Cloud(xyz=jnp.asarray(seq["scans"][i]),
                        mask=jnp.asarray(seq["scan_masks"][i])),
        stamp=jnp.float32(seq["stamps"][i]), init_guess=jnp.asarray(guess),
        guess_valid=jnp.asarray(gvalid),
        imu_rpy=jnp.asarray(seq["poses"][i, :3]),
        imu_available=jnp.asarray(True), gps_pos=jnp.zeros(3),
        gps_info=jnp.zeros(3), gps_valid=jnp.asarray(False))


def _guess(seq, i, prev):
    inc = jse3.pose6_between(jnp.asarray(seq["poses"][i - 1]),
                             jnp.asarray(seq["poses"][i]))
    return np.asarray(jse3.pose6_compose(jnp.asarray(prev), inc))


def _jax_run(seq, n, step, state):
    """tests/test_sharded_mission.py's `_run_mission`, keeping the grid
    after scan 0."""
    poses, prev, first = [], None, None
    for i in range(n):
        guess = np.zeros(6, np.float32) if i == 0 else _guess(seq, i, prev)
        state, out = step(state, _scan_input(seq, i, guess, i > 0))
        prev = np.asarray(out.pose)
        poses.append(prev)
        if i == 0:
            first = (np.asarray(state.map_grid.table),
                     np.asarray(state.map_grid.counts))
    return state, np.stack(poses), first


_JAX = {}


def jax_mission(D, seq):
    """The JAX sharded mission on a D-device mesh (run once a D)."""
    if D not in _JAX:
        mission = jax_pmission.make_sharded_mission(jax_mesh.make_mesh(D),
                                                   JAX_CFG)
        init, step = mission[0], mission[1]
        state, poses, first = _jax_run(seq, N_SCANS, step, init())
        _JAX[D] = dict(mission=mission, state=state, poses=poses, first=first)
    return _JAX[D]


def port_ranks(ranks, D, case):
    return H.rank_results(ranks[D], case)


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_mission_poses_match_jax(ranks, seq, D):
    got = port_ranks(ranks, D, "mission")
    ref = jax_mission(D, seq)["poses"]
    for r in got:
        np.testing.assert_array_equal(r["poses"], got[0]["poses"])
    err = np.linalg.norm(got[0]["poses"][:, 3:] - ref[:, 3:], axis=1)
    assert err.max() <= 5e-3, err
    rel = np.stack([np.asarray(jse3.pose6_between(
        jnp.asarray(seq["poses"][0]), jnp.asarray(seq["poses"][i])))
        for i in range(N_SCANS)])
    assert synthetic.ate_rmse(got[0]["poses"], rel) < 0.05


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_mission_shards_match_jax(ranks, seq, D):
    """Each rank holds its slice: a table of 512 buckets, the JAX global
    table's rows [d·512, (d+1)·512) after scan 0 (the counts and the empty
    slots bit-equal; the coordinates to 1e-5 m, as the single-device
    port's: the downsampled scan's centroids round differently from XLA's
    by an ulp on a few points), and 1/D of each keyframe cloud; rows a
    shard at the end within 0.5 % of JAX's."""
    got = port_ranks(ranks, D, "mission")
    ref = jax_mission(D, seq)
    table0, counts0 = ref["first"]
    counts = np.asarray(ref["state"].map_grid.counts).reshape(D, T_LOCAL)
    for d, r in enumerate(got):
        sl = slice(d * T_LOCAL, (d + 1) * T_LOCAL)
        np.testing.assert_array_equal(r["counts0"], counts0[sl])
        np.testing.assert_array_equal(r["table0"] == 1e6, table0[sl] == 1e6)
        np.testing.assert_allclose(r["table0"], table0[sl], rtol=0, atol=1e-5)
        assert r["table_shape"] == (T_LOCAL, 8, 3)
        assert r["clouds_shape"] == (16, 2048 // D, 3)
        want = int(counts[d].sum())
        assert abs(r["rows"] - want) <= 0.005 * want, (d, r["rows"], want)


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_mission_capacity_beyond_one_shard(ranks, D):
    """The mission's map overflows one shard: the rows in use exceed one
    rank's T_local x C."""
    got = port_ranks(ranks, D, "mission")
    rows = sum(r["rows"] for r in got)
    assert rows > T_LOCAL * 8, rows
    assert all(r["rows"] <= T_LOCAL * 8 for r in got)


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_mission_replicated_leaves_agree(ranks, D):
    """Every replicated leaf holds the same bits on every rank: the ranks
    branched alike throughout."""
    for r in port_ranks(ranks, D, "mission"):
        c = r["checksums"]
        assert c.shape[0] == D
        assert (c == c[0]).all(), c


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_loop_readers_match_one_device(ranks, D):
    """The loop detector and the archive verifier, reading only the
    keyframes they verify through the sharded `keyframe_rows`, give the
    bits of the single-device readers on the gathered store; the detector
    verified a candidate, so the gathered rows were read."""
    for r in port_ranks(ranks, D, "mission"):
        got, ref = r["loop_readers"]["sharded"], r["loop_readers"]["single"]
        assert len(got["iters"]) >= 1 and got["iters"] == ref["iters"]
        for k in ref["aux"]:
            np.testing.assert_array_equal(got["aux"][k], ref["aux"][k], k)
        assert got["archive"] == ref["archive"]
        for a, b in zip(got["pending"] + got["gps"],
                        ref["pending"] + ref["gps"]):
            np.testing.assert_array_equal(a, b)


def test_sharded_mission_at_another_halo_matches_jax(ranks, seq):
    """The mission at halo "xy" (24 slots a bucket) at D=2 against the JAX
    sharded mission's run recorded in `sharded_halos_jax.npz` on the same
    scans: poses within the "z" mission's 5e-3 m, rows a shard within
    0.5 %, replicated leaves equal on every rank."""
    f = np.load(HALO_FIXTURE)
    assert str(f["mission_xy_seq_sha256"]) == H.arrays_sha256(
        *(seq[k] for k in sorted(seq)))
    assert str(f["mission_xy_cfg"]) == repr(mission_config(jax_config, HALO,
                                                           HALO_CAP))
    got = port_ranks(ranks, 2, "mission_xy")
    ref = f["mission_xy_poses"]
    err = np.linalg.norm(got[0]["poses"][:, 3:] - ref[:, 3:], axis=1)
    assert err.max() <= 5e-3, err
    for d, r in enumerate(got):
        np.testing.assert_array_equal(r["poses"], got[0]["poses"])
        assert r["table_shape"] == (T_LOCAL, HALO_CAP, 3)
        want = int(f["mission_xy_rows"][d])
        assert abs(r["rows"] - want) <= 0.005 * want, (d, r["rows"], want)
        assert (r["checksums"] == r["checksums"][0]).all()


def test_runner_refuses_a_device_other_than_its_mesh(ranks):
    """`Runner(mesh=)` on a device other than the rank's mesh device (here
    a CPU mesh and "cuda:1") raises before it builds anything."""
    for msg in port_ranks(ranks, 2, "runner_device"):
        assert msg is not None and "mesh device cpu" in msg, msg


def test_sharded_mission_full_correction_runs_sharded_solver(ranks, seq):
    """The injected loop, consumed at the next keyframe save, corrected
    through the column-sharded sparse solver and the per-rank rebuild; the
    rebuilt shards still register the next scan."""
    got = port_ranks(ranks, 2, "full_correction")
    init, step, correct, _ = jax_mission(2, seq)["mission"]
    st, poses, _ = _jax_run(seq, N_CORRECTION, step, init())
    n_kf = int(st.store.count)
    meas = jse3.pose6_between(st.store.poses[n_kf - 1], st.store.poses[0])
    st, added = jax_lio.inject_loop_constraint(
        st, jnp.int32(n_kf - 1), jnp.int32(0), meas,
        jnp.full(6, 1e2, jnp.float32))
    prev = poses[-1]
    for i in range(N_CORRECTION, N_CORRECTION + 3):
        st, out = step(st, _scan_input(seq, i, _guess(seq, i, prev), True))
        prev = np.asarray(out.pose)
        if int(st.loop_count) >= 1:
            break
    before = np.asarray(st.graph.poses)
    st = correct(st)
    after = np.asarray(st.graph.poses)
    r = got[0]
    for other in got[1:]:
        np.testing.assert_array_equal(other["graph_after"], r["graph_after"])
    assert r["n_kf"] == n_kf >= 3 and r["added"] and bool(added)
    assert r["consumed_at"] == i and r["loop_count"] == 1
    assert not r["needs_full_solve"]
    m = np.asarray(st.graph.pose_mask)
    np.testing.assert_allclose(r["graph_before"][m], before[m], atol=5e-3)
    np.testing.assert_allclose(r["graph_after"][m], after[m], atol=5e-3)
    assert np.abs(r["graph_after"][m] - r["graph_before"][m]).max() > 0
    assert r["post_inliers"] > 200 and np.isfinite(r["post_pose"]).all()
    for c in (x["checksums"] for x in got):
        assert (c == c[0]).all()


def test_runner_sharded_mission_matches_jax(ranks):
    """`Runner(cfg, device="cpu", mesh=..., loop_every=6, fetch_every=2)`
    against the JAX Runner with a 2-device mesh over the same scans."""
    got = port_ranks(ranks, 2, "runner")
    jr, before = ranks["jax_runner"]
    ref = np.stack(jr.trajectory[:before])
    assert got[0]["trajectory"].shape == ref.shape == (N_RUNNER, 6)
    err = np.linalg.norm(got[0]["trajectory"][:, 3:] - ref[:, 3:], axis=1)
    assert err.max() <= 5e-3, err
    assert got[0]["table_shape"] == (T_LOCAL, 8, 3)
    for r in got:
        np.testing.assert_array_equal(r["trajectory"], got[0]["trajectory"])
        assert (r["checksums"] == r["checksums"][0]).all()


def test_checkpoint_jax_sharded_runner_loads_into_port(ranks, ckpt_paths):
    """The JAX Runner with a mesh writes its global layout; the port's
    sharded Runner resumes from it with every leaf of its global view equal
    and each rank holding its slice."""
    got = port_ranks(ranks, 2, "resume_from")
    with np.load(ckpt_paths["jax"]) as z:
        want = [z[f"leaf_{i:04d}"] for i in range(len(got[0]["leaves"]))]
    for r in got:
        assert r["local_shapes"] == ((T_LOCAL, 8, 3), (16, 1024, 3))
        for (name, leaf), w in zip(r["leaves"], want):
            np.testing.assert_array_equal(leaf, w.astype(leaf.dtype),
                                          err_msg=name)


def test_checkpoint_port_sharded_runner_loads_into_jax(ranks, ckpt_paths):
    """The port's sharded Runner writes the same global layout: the JAX
    package loads it with its sharded MapOps, every leaf equal to the
    port's global view."""
    got = port_ranks(ranks, 2, "runner")[0]
    ops = jax_pmission.make_sharded_map_ops(jax_mesh.make_mesh(2), JAX_CFG)
    state, imu_state, meta = jax_checkpoint.load_checkpoint(
        ckpt_paths["port"], JAX_CFG, ops=ops)
    assert int(meta["scan_count"]) == N_RUNNER and imu_state is not None
    leaves = jax.tree_util.tree_leaves(state)
    assert len(leaves) == len(got["leaves"])
    assert np.asarray(leaves[0]).shape == (16, 6)
    for (name, leaf), w in zip(got["leaves"], leaves):
        np.testing.assert_array_equal(leaf, np.asarray(w), err_msg=name)


def test_resumed_sharded_runner_continues_as_jax(ranks):
    """After resuming from the JAX checkpoint, the port's sharded Runner
    over the next scans follows the JAX Runner that wrote it."""
    got = port_ranks(ranks, 2, "resume_from")
    jr, before = ranks["jax_runner"]
    ref = np.stack(jr.trajectory[before:])
    tail = got[0]["trajectory"][-len(ref):]
    err = np.linalg.norm(tail[:, 3:] - ref[:, 3:], axis=1)
    assert err.max() <= 5e-3, err
    for r in got:
        assert (r["checksums"] == r["checksums"][0]).all()
