"""Rank processes of the port's sharded tests (tests/test_torch_sharding.py,
test_torch_parallel_sparse.py, test_torch_sharded_mission.py).

Run by `torch_port_helpers.spawn_ranks`, one process a rank:

    python tests/torch_dist_workers.py --rank R --world W --dir DIR

Each rank joins a gloo process group through a FileStore in DIR (60 s
collective timeout, one torch thread), or with `--rendezvous lio` through
`parallel.distributed.initialize` from the LIO_* variables (a TCP store
served by rank 0), reads the cases from DIR/cases.pkl
(a list of (name, mesh shape, keyword arguments) with numpy inputs), runs
them in order on CPU tensors, and writes {name: numpy results} to
DIR/result_R.pkl.  This module imports torch and the port only, never
jax: the parent test module does the JAX side.  Not collected by pytest.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time
import zlib
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lio_slam_tpu_torch.graph import factors as F  # noqa: E402
from lio_slam_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from lio_slam_tpu_torch.utils import pointcloud as pc  # noqa: E402
from lio_slam_tpu_torch.utils import se3  # noqa: E402

# the leaves each rank holds only a slice of; every other leaf of LioState
# is replicated
SHARDED = ("map_grid.table", "map_grid.counts", "store.clouds",
           "store.cloud_masks")


def t(x):
    return torch.from_numpy(np.array(x))


def n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def named_leaves(tree, prefix=""):
    """[(dotted name, tensor)] of a NamedTuple tree, depth first."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += named_leaves(getattr(tree, f), f"{prefix}{f}.")
        return out
    return [(prefix[:-1], tree)]


def replicated_checksums(mesh, *trees) -> np.ndarray:
    """(D, L) crc32 of every replicated leaf of `trees`, gathered from
    every rank: equal rows mean the ranks hold the same bits."""
    crcs = [zlib.crc32(n(x).tobytes()) for tree in trees
            for name, x in named_leaves(tree)
            if isinstance(x, torch.Tensor) and name not in SHARDED]
    return n(mesh_mod.all_gather(torch.tensor(crcs, dtype=torch.int64), mesh))


def graph_from(arrays: dict) -> F.PoseGraph:
    return F.PoseGraph(**{k: t(v) for k, v in arrays.items()})


def result_of(res) -> dict:
    return {"pose": n(res.pose), "iterations": int(res.iterations),
            "num_inliers": int(res.num_inliers),
            "degenerate": bool(res.degenerate),
            "converged": bool(res.converged),
            "mean_residual": float(res.mean_residual)}


# ---- test_torch_sharding.py ----

def sharded_register(mesh, scan, smask, map_pts, map_mask, init, reg_cfg,
                     axis="data"):
    from lio_slam_tpu_torch.parallel import registration as preg

    register = preg.make_sharded_register(mesh, reg_cfg, axis=axis)
    res = register(mesh_mod.shard_points(mesh, t(scan), axis),
                   mesh_mod.shard_points(mesh, t(smask), axis), t(map_pts),
                   t(map_mask), t(init))
    return result_of(res)


def sharded_knn(mesh, query, query_mask, ref, ref_mask, k):
    from lio_slam_tpu_torch.parallel import registration as preg

    d, i = preg.make_sharded_knn(mesh, k=k)(
        t(query), t(query_mask), mesh_mod.shard_points(mesh, t(ref)),
        mesh_mod.shard_points(mesh, t(ref_mask)))
    return {"dist2": n(d), "idx": n(i)}


def graph_solver(mesh, graph, iterations):
    from lio_slam_tpu_torch.parallel import graph as pgraph

    g = graph_from(graph)
    out = pgraph.make_sharded_solver(mesh)(g, g.pose_mask,
                                           iterations=iterations)
    return {"poses": n(out.poses), "pose_mask": n(out.pose_mask)}


def map_sharded_register(mesh, scan, smask, map_pts, map_mask, init, reg_cfg,
                         axis="data"):
    from lio_slam_tpu_torch.parallel import registration as preg

    register = preg.make_map_sharded_register(mesh, reg_cfg, axis=axis)
    res = register(t(scan), t(smask),
                   mesh_mod.shard_points(mesh, t(map_pts), axis),
                   mesh_mod.shard_points(mesh, t(map_mask), axis), t(init))
    return result_of(res)


def map_sharded_sequence(mesh, scans, smask, map_pts, map_mask, init0,
                         reg_cfg):
    """The 3-step sequence: each scan's initial guess is the previous
    estimate."""
    from lio_slam_tpu_torch.parallel import registration as preg

    register = preg.make_map_sharded_register(mesh, reg_cfg)
    mp = mesh_mod.shard_points(mesh, t(map_pts))
    mm = mesh_mod.shard_points(mesh, t(map_mask))
    pose, poses = t(init0), []
    for scan in scans:
        pose = register(t(scan), t(smask), mp, mm, pose).pose
        poses.append(n(pose))
    return {"poses": np.stack(poses)}


# ---- test_torch_parallel_sparse.py ----

def sparse_solve(mesh, graph, iterations, axes):
    from lio_slam_tpu_torch.parallel import sparse as psp

    out = psp.make_sharded_sparse_solver(mesh, axes=axes)(
        graph_from(graph), iterations=iterations)
    return {"poses": n(out.graph.poses), "chi2": float(out.chi2)}


# ---- test_torch_multislice.py, test_torch_distributed.py ----

def multislice_mesh(mesh):
    """The mesh's axes and shape, and the messages of a mesh of the wrong
    size and of factor rows that do not divide."""
    from lio_slam_tpu_torch.parallel import multislice as ms

    errors = []
    for bad in (lambda: ms.make_multislice_mesh(2, 4, device_type="cpu"),
                lambda: ms.shard_factors(mesh, torch.zeros(6, 3))):
        try:
            bad()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return {"names": tuple(mesh.mesh_dim_names),
            "shape": tuple(mesh.mesh.shape), "errors": errors,
            "rank": dist.get_rank()}


def multislice_solver(mesh, graph, iterations):
    from lio_slam_tpu_torch.parallel import distributed as pdist
    from lio_slam_tpu_torch.parallel import multislice as ms

    g = F.PoseGraph(**{k: pdist.replicated(mesh, v) for k, v in graph.items()})
    out = ms.make_multislice_solver(mesh)(g, g.pose_mask,
                                          iterations=iterations)
    return {"poses": n(out.poses), "pose_mask": n(out.pose_mask)}


def multislice_register(mesh, scan, smask, map_pts, map_mask, init, reg_cfg):
    """The scan placed by `distributed.factor_sharded`, the map and the
    start by `distributed.replicated`."""
    from lio_slam_tpu_torch.parallel import distributed as pdist
    from lio_slam_tpu_torch.parallel import multislice as ms

    res = ms.make_multislice_register(mesh, reg_cfg)(
        pdist.factor_sharded(mesh, scan), pdist.factor_sharded(mesh, smask),
        pdist.replicated(mesh, map_pts), pdist.replicated(mesh, map_mask),
        pdist.replicated(mesh, init))
    return dict(result_of(res),
                shard_rows=int(pdist.factor_sharded(mesh, scan).shape[0]))


def psum_staged(mesh, x):
    """Each rank's sum of its `shard_factors` rows of `x`, reduced staged
    and by one all_reduce over the whole group."""
    from lio_slam_tpu_torch.parallel import multislice as ms

    v = ms.shard_factors(mesh, t(x)).sum()
    flat = v.clone()
    dist.all_reduce(flat)
    return {"staged": float(ms.psum_staged(v, mesh)), "flat": float(flat)}


# ---- test_torch_sharded_mission.py ----

def _scan_input(seq, i, guess, gvalid):
    from lio_slam_tpu_torch.pipeline import lio

    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    return lio.ScanInput(
        cloud=pc.Cloud(xyz=t(seq["scans"][i]), mask=t(seq["scan_masks"][i])),
        stamp=f32(seq["stamps"][i]), init_guess=t(guess),
        guess_valid=torch.tensor(gvalid), imu_rpy=t(seq["poses"][i, :3]),
        imu_available=torch.tensor(True), gps_pos=torch.zeros(3),
        gps_info=torch.zeros(3), gps_valid=torch.tensor(False))


def _guess(seq, i, prev):
    inc = se3.pose6_between(t(seq["poses"][i - 1]), t(seq["poses"][i]))
    return n(se3.pose6_compose(t(prev), inc))


def _run_mission(seq, n_scans, step, state, after_first=None):
    """The JAX test's `_run_mission`: each guess composed from the previous
    estimate and the truth increment."""
    poses, prev = [], None
    for i in range(n_scans):
        guess = np.zeros(6, np.float32) if i == 0 else _guess(seq, i, prev)
        state, out = step(state, _scan_input(seq, i, guess, i > 0))
        prev = n(out.pose)
        poses.append(prev)
        if i == 0 and after_first is not None:
            after_first(state)
    return state, np.stack(poses)


def _loop_readers(ops, cfg, state):
    """The loop detector and the archive verifier run twice on the
    mission's end state, every keyframe but the newest made 1000 s older so
    the detector has candidates: on this rank's state, reading keyframes
    through the sharded `ops.keyframe_rows`, and on the gathered global
    state with the single-device reader.  Returns both runs' outputs."""
    from lio_slam_tpu_torch.pipeline import archive, loop_closure
    from lio_slam_tpu_torch.pipeline import keyframes as kf

    store = state.store
    K = store.stamps.shape[0]
    old = torch.arange(K) < store.count - 1
    state = state._replace(store=store._replace(
        stamps=store.stamps - 1000.0 * old))
    whole = ops.gather(state, grid=False)
    cur = int(store.count) - 1
    submap = kf.transform_keyframe_clouds(whole.store)[0]
    out = {}
    for name, st, rows in (("sharded", state, ops.keyframe_rows),
                           ("single", whole, kf.keyframe_rows)):
        st, aux = loop_closure.make_loop_detector(cfg, rows=rows)(st)
        st, added, fit = archive.make_archive_verifier(cfg, rows=rows)(
            st, submap, whole.store.cloud_masks[0], whole.store.poses[cur],
            5.0)
        out[name] = {
            "aux": {k: n(v) for k, v in aux.items() if k != "loop_iters"},
            "iters": [int(i) for i in aux["loop_iters"]],
            "archive": (bool(added), float(fit)),
            "pending": [n(getattr(st, k)) for k in
                        ("pend_i", "pend_j", "pend_meas", "pend_info",
                         "pend_mask")],
            "gps": [n(st.graph.gps_i), n(st.graph.gps_mask)]}
    return out


def mission(mesh, cfg, seq, n_scans):
    """The sharded mission over `n_scans` scans: poses, this rank's table
    after scan 0, rows a rank at the end, the local shapes, the
    replicated-leaf checksums, and the loop readers on the end state
    (`_loop_readers`)."""
    from lio_slam_tpu_torch.parallel import mission as pm

    init, step, _, ops = pm.make_sharded_mission(mesh, cfg)
    first = {}

    def keep(state):
        first["table"] = n(state.map_grid.table).copy()
        first["counts"] = n(state.map_grid.counts).copy()

    state, poses = _run_mission(seq, n_scans, step, init(), keep)
    return {"poses": poses, "table0": first["table"],
            "counts0": first["counts"],
            "rows": int(state.map_grid.counts.sum()),
            "table_shape": tuple(state.map_grid.table.shape),
            "clouds_shape": tuple(state.store.clouds.shape),
            "checksums": replicated_checksums(mesh, state),
            "loop_readers": _loop_readers(ops, cfg, state)}


def runner_device(mesh, cfg):
    """The message of `Runner(mesh=)` refusing a device other than the
    rank's mesh device (None if it did not refuse)."""
    from lio_slam_tpu_torch.pipeline.runner import Runner

    try:
        Runner(cfg, device="cuda:1", mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def full_correction(mesh, cfg, seq, n_scans):
    """The JAX test's injected loop: the constraint queued, consumed at the
    next keyframe save, the full correction through the sharded solver,
    then one more scan against the rebuilt shards."""
    from lio_slam_tpu_torch.parallel import mission as pm
    from lio_slam_tpu_torch.pipeline import lio

    init, step, correct, _ = pm.make_sharded_mission(mesh, cfg)
    st, poses = _run_mission(seq, n_scans, step, init())
    n_kf = int(st.store.count)
    meas = se3.pose6_between(st.store.poses[n_kf - 1], st.store.poses[0])
    st, added = lio.inject_loop_constraint(st, n_kf - 1, 0, meas,
                                           torch.full((6,), 1e2))
    prev = poses[-1]
    for i in range(n_scans, n_scans + 3):
        inp = _scan_input(seq, i, _guess(seq, i, prev), True)
        st, out = step(st, inp)
        prev = n(out.pose)
        if int(st.loop_count) >= 1:
            break
    loop_count = int(st.loop_count)
    before = n(st.graph.poses)
    st = correct(st)
    j = min(i + 1, len(seq["stamps"]) - 1)
    st, out2 = step(st, _scan_input(seq, j, prev, True))
    return {"n_kf": n_kf, "added": bool(added), "loop_count": loop_count,
            "needs_full_solve": bool(st.needs_full_solve),
            "graph_before": before, "graph_after": n(st.graph.poses),
            "consumed_at": i, "post_inliers": int(out2.num_inliers),
            "post_pose": n(out2.pose),
            "checksums": replicated_checksums(mesh, st)}


def _feed(runner, seq, lo, hi):
    from lio_slam_tpu_torch.io import formats

    for i in range(lo, hi):
        m = seq["scan_masks"][i]
        k = int(m.sum())
        runner.process_scan(formats.StandardScan(
            xyz=seq["scans"][i][m], intensity=np.zeros(k, np.float32),
            ring=np.zeros(k, np.uint16), time=np.zeros(k, np.float32),
            stamp=float(seq["stamps"][i])))
    runner.drain()


def runner(mesh, cfg, seq, n_scans, ckpt_path):
    """`Runner(cfg, device="cpu", mesh=mesh, loop_every=6, fetch_every=2)`
    over `n_scans` scans; its checkpoint (the global layout, written by
    rank 0) to `ckpt_path`."""
    from lio_slam_tpu_torch.pipeline.runner import Runner

    r = Runner(cfg, device="cpu", loop_every=6, mesh=mesh, fetch_every=2)
    _feed(r, seq, 0, n_scans)
    r.save_checkpoint(ckpt_path)
    g = r.global_state()
    return {"trajectory": np.stack(r.trajectory),
            "table_shape": tuple(r.state.map_grid.table.shape),
            "leaves": [(k, n(v)) for k, v in named_leaves(g)],
            "checksums": replicated_checksums(mesh, r.state, r.imu_state)}


def resume_from(mesh, cfg, seq, path, lo, hi, wait_s):
    """`Runner.resume(path, cfg, mesh=mesh)` of a checkpoint the parent
    writes (waited for up to `wait_s`): its leaves in the global layout,
    this rank's shapes, then scans [lo, hi) fed on."""
    from lio_slam_tpu_torch.pipeline.runner import Runner

    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > wait_s:
            raise TimeoutError(f"no checkpoint at {path} after {wait_s} s")
        time.sleep(0.1)
    r = Runner.resume(path, cfg, device="cpu", loop_every=6, mesh=mesh,
                      fetch_every=2)
    leaves = [(k, n(v)) for k, v in named_leaves(r.global_state())]
    shapes = (tuple(r.state.map_grid.table.shape),
              tuple(r.state.store.clouds.shape))
    _feed(r, seq, lo, hi)
    return {"leaves": leaves, "local_shapes": shapes,
            "trajectory": np.stack(r.trajectory),
            "checksums": replicated_checksums(mesh, r.state, r.imu_state)}


CASES = {f.__name__: f for f in (
    sharded_register, sharded_knn, graph_solver, map_sharded_register,
    map_sharded_sequence, sparse_solve, multislice_mesh, multislice_solver,
    multislice_register, psum_staged, mission, runner_device,
    full_correction, runner, resume_from)}


def make_case_mesh(shape):
    """A 1-D ("data",) mesh for an int, a ("slice", "data") one for a
    pair, `distributed.global_mesh()` for "global"."""
    if shape == "global":
        from lio_slam_tpu_torch.parallel import distributed as pdist

        return pdist.global_mesh(device_type="cpu")
    if isinstance(shape, int):
        return mesh_mod.make_mesh(shape, device_type="cpu")
    return mesh_mod.make_mesh_2d(*shape, device_type="cpu")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--rendezvous", choices=("file", "lio"), default="file")
    a = ap.parse_args()
    torch.set_num_threads(1)
    if a.rendezvous == "lio":
        from lio_slam_tpu_torch.parallel import distributed as pdist

        pdist.initialize(device_type="cpu", timeout_s=60)
        assert (dist.get_rank(), dist.get_world_size()) == (a.rank, a.world)
    else:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(a.dir, "store"),
                                         a.world),
            rank=a.rank, world_size=a.world, timeout=timedelta(seconds=60))
    with open(os.path.join(a.dir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    out = {}
    for name, shape, kwargs in cases:
        out[name] = CASES[kwargs.pop("case", name)](make_case_mesh(shape),
                                                   **kwargs)
    tmp = os.path.join(a.dir, f"result_{a.rank}.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, os.path.join(a.dir, f"result_{a.rank}.pkl"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
