"""Record the JAX reference runs of chip_smoke.py's missions as fixtures.

chip_smoke.py holds the PyTorch port on the GPU to the JAX package's
trajectory without importing jax.  This script runs the JAX `Runner` on the
CPU over exactly those missions and saves what the smoke run compares:

- `smoke_mission_jax.npz`: the port's `bench_config()`, 40 scans of 32768
  points, seed 0, speed 2 m/s, the synthetic IMU windows, loop closure and
  GPS off: per-scan poses, keyframe flags, GN iteration counts, the
  keyframe count and the IMU front-end state each scan starts from.
- `loop_mission_jax.npz`: `loop_mission_config()` (loop closure and GPS
  on), 125 scans of a closed circle with GPS fixes made from the truth, the
  loop detector every 10 scans: per-scan poses, keyframe flags, GN
  iterations, loop and GPS factor counts, the provenance of every detector
  cycle, the scans at which a full correction ran, the final keyframe
  poses.
- `archive_mission_jax.npz`: `archive_mission_config()` (the loop mission
  with a 16-keyframe store and the keyframe archive on), 125 scans, with
  `fetch_every=2`, a mission log and auto-checkpoints every 50 scans:
  per-scan poses, keyframe flags, GN iterations, evictions, archived
  keyframes, archive loops and their (i, j) events, loop / GPS / anchor
  counts, the scans of the full corrections; then on the final state the
  map products' counts (SOR-kept points, occupied height cells, saved map
  points at 0.4 m) and the relocalization of three first-lap scans.
- `bag_mission_jax.npz`: the two bags of `synthetic_mission`
  (`bag_mission_bag_kwargs()`, `hostile_bag_kwargs()`), written by the
  port's `write_synthetic_bag` and replayed through the JAX `replay_bag` +
  `Runner`: the bags' sha256 and sizes; for the bag mission
  (`loop_mission_config()`, the loop detector every 10 scans, an output
  bag recorded) per-scan poses, keyframe flags, GN iterations, loop and
  GPS factor counts, the detector cycles, the scans of the full
  corrections, the ATE against the rebased truth and the output bag's
  records per topic; for the hostile bag (`hostile_bag_config()`) per-scan
  poses, keyframe flags, GN iterations and GPS factor counts (keys with
  the prefix `hostile_`).  Both replays run with the JAX
  `LiveFeed._window_for` patched to the port's repaired window start
  (`torch_port_helpers.repaired_jax_window_for`): the JAX feed hands the
  IMU sample one float64 ulp after a scan stamp to two corrections.
- `corner_mission_jax.npz` and `rebuild_mission_jax.npz`: the corner
  missions of `synthetic_mission` (`corner_mission_config()` on the
  incremental map, 60 scans, and on the rebuild-mode map, 40 scans; the
  port's `make_sweep_sequence` through `rig_sensor_for(cfg)`, 32768 points,
  the IMU windows of `make_imu_windows(sweep_cover=sweep_time)`): the
  sha256 of the port's scans, per-scan poses, keyframe flags and GN
  iterations, the keyframe count, the corners stored per keyframe and the
  ATE against truth.

On the CPU the JAX registration takes its unfused path, which finds fresh
correspondences at every GN iteration whatever `corr_refresh_every` says
(`registration._maybe_fused` returns None there).  The mission runs
`corr_refresh_every=2`, so this script gives the registration the fused
path it takes off the CPU, with the Pallas kernel in interpret mode and the
candidate block held between refreshes, as the port does.

Run by hand from the repository root (`smoke`, `loop`, `archive`, `bag`,
`corner`, or all five when no argument is given):

    python tests/torch_port_make_fixture.py [smoke|loop|archive|bag|corner]

It is not a test (pytest does not collect it).
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from lio_slam_tpu import config as jax_config  # noqa: E402
from lio_slam_tpu.ops import registration as jreg  # noqa: E402
from lio_slam_tpu.pipeline.runner import Runner  # noqa: E402
from lio_slam_tpu.utils import se3 as jse3  # noqa: E402
from lio_slam_tpu_torch.io import synthetic  # noqa: E402
from lio_slam_tpu_torch.pipeline import synthetic_mission as sm  # noqa: E402

sys.path.insert(0, os.path.join(ROOT, "tests"))
from torch_port_helpers import (jax_fused_interpret, repaired_jax_feed,  # noqa: E402
                                to_jax_config)

FIXTURES = os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures")
OUT = os.path.join(FIXTURES, "smoke_mission_jax.npz")
LOOP_OUT = os.path.join(FIXTURES, "loop_mission_jax.npz")
ARCHIVE_OUT = os.path.join(FIXTURES, "archive_mission_jax.npz")
BAG_OUT = os.path.join(FIXTURES, "bag_mission_jax.npz")
CORNER_OUT = os.path.join(FIXTURES, "corner_mission_jax.npz")
REBUILD_OUT = os.path.join(FIXTURES, "rebuild_mission_jax.npz")


def count_iterations(runner):
    """Wrap `runner.step` so that the returned list collects every scan's GN
    iteration count."""
    iters = []
    step = runner.step

    def counting_step(state, inp):
        state, out = step(state, inp)
        iters.append(int(out.registration_iters))
        return state, out

    runner.step = counting_step
    return iters


def loop_mission():
    """The JAX `Runner` over the loop mission; writes LOOP_OUT."""
    cfg = sm.loop_mission_config()
    seq, scans, imus, fixes = sm.loop_mission_inputs(cfg)
    runner = Runner(to_jax_config(cfg, jax_config), loop_every=sm.LOOP_EVERY)
    iters = count_iterations(runner)
    corrected = []
    full_correct = runner.full_correct

    def watching_correct(state):
        if bool(state.needs_full_solve):
            corrected.append(runner.scan_count)
        return full_correct(state)

    runner.full_correct = watching_correct
    cycles = []
    detector = runner.detector

    def watching_detector(state):
        state, aux = detector(state)
        cycles.append({"scan": runner.scan_count - 1,
                       **{k: np.array(v) for k, v in aux.items()}})
        return state, aux

    runner.detector = watching_detector
    t0 = time.time()
    results, loops, gps = [], [], []
    for i in range(len(scans)):
        results.append(runner.process_scan(scans[i], imu=imus[i],
                                           gps_fixes=fixes[i]))
        loops.append(int(runner.state.loop_count))
        gps.append(int(runner.state.gps_count))
    poses = np.stack([r.pose for r in results]).astype(np.float32)
    ate = synthetic.ate_rmse(poses, sm.relative_truth(seq))
    n_kf = int(runner.state.store.count)
    cyc = lambda k: np.stack([c[k] for c in cycles])
    np.savez(LOOP_OUT, poses=poses,
             is_keyframe=np.array([r.is_keyframe for r in results]),
             registration_iters=np.array(iters, np.int32),
             keyframes=np.int32(n_kf), ate_rmse_m=np.float32(ate),
             loop_count=np.array(loops, np.int32),
             gps_count=np.array(gps, np.int32),
             full_correction_scans=np.array(corrected, np.int32),
             cycle_scan=np.array([c["scan"] for c in cycles], np.int32),
             loop_accepted=cyc("loop_accepted"),
             loop_pair_i=cyc("loop_pair_i"), loop_pair_j=cyc("loop_pair_j"),
             loop_fitness=cyc("loop_fitness"),
             keyframe_poses=np.array(runner.state.store.poses[:n_kf]))
    print(f"wrote {LOOP_OUT}: {len(results)} scans, {n_kf} keyframes, ATE "
          f"{ate:.5f} m, {sum(iters)} GN iterations of mapping, "
          f"{loops[-1]} loop factors, {gps[-1]} GPS factors, full "
          f"corrections at scans {corrected}, {time.time() - t0:.1f} s")
    for c in cycles:
        print(f"  detector cycle at scan {c['scan']}: accepted "
              f"{c['loop_accepted'].tolist()}, pair "
              f"{c['loop_pair_i'].tolist()} -> {c['loop_pair_j'].tolist()}, "
              f"fitness {c['loop_fitness'].tolist()}")


def archive_mission():
    """The JAX `Runner` over the archive mission with the arguments
    chip_smoke.py gives the port's, then the map products and three
    relocalizations on its final state; writes ARCHIVE_OUT."""
    import json
    import shutil
    import tempfile

    from lio_slam_tpu.ops import heightmap as jhm
    from lio_slam_tpu.pipeline import relocalization as jreloc
    from lio_slam_tpu.utils import pointcloud as jpc

    cfg = sm.archive_mission_config()
    jcfg = to_jax_config(cfg, jax_config)
    seq, scans, imus, fixes = sm.loop_mission_inputs(cfg, n_scans=sm.ARCHIVE_SCANS)
    tmp = tempfile.mkdtemp()
    log_path = os.path.join(tmp, "mission.jsonl")
    runner = Runner(jcfg, loop_every=sm.LOOP_EVERY, fetch_every=2,
                    mission_log=log_path,
                    auto_checkpoint=os.path.join(tmp, "auto.npz"),
                    checkpoint_every=50)
    iters = count_iterations(runner)
    corrected = []
    full_correct = runner.full_correct

    def watching_correct(state):
        if bool(state.needs_full_solve):
            corrected.append(runner.scan_count)
        return full_correct(state)

    runner.full_correct = watching_correct
    t0 = time.time()
    for i in range(len(scans)):
        runner.process_scan(scans[i], imu=imus[i], gps_fixes=fixes[i])
    runner.drain()
    health = runner.health()
    st = runner.state
    A = cfg.static.max_archive_anchors
    gmask = np.array(st.graph.gps_mask)
    n_kf = int(st.store.count)

    # the map products on the final state (resolution 0.4 for save_map)
    pm = runner.local_planning_map()
    hmap = runner.height_map()
    saved = runner.save_map(os.path.join(tmp, "maps"), resolution=0.4)
    normals, slope = jhm.normals_and_slope(hmap)
    sdf = jhm.obstacle_sdf(hmap, float(np.asarray(runner.trajectory[-1])[5]))
    reloc = jreloc.make_relocalizer(jcfg)
    rel = {"success": [], "matched_kf": [], "pose": []}
    for i in sm.RELOC_SCANS:
        r = reloc(st, jpc.Cloud(xyz=seq.scans[i], mask=seq.scan_masks[i]))
        rel["success"].append(bool(r.success))
        rel["matched_kf"].append(int(r.matched_kf))
        rel["pose"].append(np.array(r.pose))
    runner.close()
    recs = [json.loads(line) for line in open(log_path)]
    shutil.rmtree(tmp)
    steps = [r for r in recs if "event" not in r]
    events = [r for r in recs if r.get("source") == "archive"]
    poses = np.stack(runner.trajectory).astype(np.float32)
    ate = synthetic.ate_rmse(poses, sm.relative_truth(seq))
    np.savez(ARCHIVE_OUT, poses=poses,
             is_keyframe=np.array([r["keyframe"] for r in steps]),
             registration_iters=np.array(iters, np.int32),
             keyframes=np.int32(n_kf), ate_rmse_m=np.float32(ate),
             loop_count=np.int32(int(st.loop_count)),
             gps_count=np.int32(int(st.gps_count)),
             anchors=np.int32(gmask[len(gmask) - A:].sum()),
             live_gps=np.int32(gmask[:len(gmask) - A].sum()),
             evictions=np.int32(health["keyframe_evictions"]),
             archived_keyframes=np.int32(health["archived_keyframes"]),
             archive_loops=np.int32(health["archive_loops"]),
             archive_events=np.array([[e["i"], e["j"]] for e in events],
                                     np.int32).reshape(-1, 2),
             full_correction_scans=np.array(corrected, np.int32),
             keyframe_poses=np.array(st.store.poses[:n_kf]),
             sor_kept=np.int32(int(pm.count())),
             height_cells=np.int32(int(np.isfinite(np.array(hmap.elevation)).sum())),
             saved_points=np.int32(saved.num_points),
             slope_cells=np.int32(int(np.isfinite(np.array(slope)).sum())),
             sdf_negative=np.int32(int((np.array(sdf) < 0).sum())),
             reloc_scans=np.array(sm.RELOC_SCANS, np.int32),
             reloc_success=np.array(rel["success"]),
             reloc_matched_kf=np.array(rel["matched_kf"], np.int32),
             reloc_pose=np.stack(rel["pose"]).astype(np.float32))
    print(f"wrote {ARCHIVE_OUT}: {len(poses)} scans, {n_kf} keyframes, "
          f"{health['keyframe_evictions']} evictions, "
          f"{health['archived_keyframes']} archived, "
          f"{health['archive_loops']} archive loops {[(e['i'], e['j']) for e in events]}, "
          f"{int(st.loop_count)} loop factors, {int(st.gps_count)} GPS factors, "
          f"anchors {int(gmask[len(gmask) - A:].sum())}, ATE {ate:.5f} m, full "
          f"corrections at scans {corrected}; products: SOR kept "
          f"{int(pm.count())}, height cells "
          f"{int(np.isfinite(np.array(hmap.elevation)).sum())}, saved "
          f"{saved.num_points}; relocalization {rel['success']} "
          f"{rel['matched_kf']}; {time.time() - t0:.1f} s")


def replay_jax_bag(cfg, path, topics, **runner_kw):
    """The JAX `replay_bag` + `Runner` over the bag at `path`: (runner,
    results, GN iterations a scan, loop and GPS factor counts after each
    scan, detector cycles, scans of the full corrections)."""
    from lio_slam_tpu.io.bag_replay import BagTopics, replay_bag

    runner = Runner(to_jax_config(cfg, jax_config), **runner_kw)
    iters = count_iterations(runner)
    corrected, cycles = [], []
    full_correct, detector = runner.full_correct, runner.detector

    def watching_correct(state):
        if bool(state.needs_full_solve):
            corrected.append(runner.scan_count)
        return full_correct(state)

    def watching_detector(state):
        state, aux = detector(state)
        cycles.append({"scan": runner.scan_count - 1,
                       **{k: np.array(v) for k, v in aux.items()}})
        return state, aux

    runner.full_correct, runner.detector = watching_correct, watching_detector
    results, loops, gps = [], [], []
    for r in replay_bag(runner, path, BagTopics(**topics)):
        results.append(r)
        loops.append(int(runner.state.loop_count))
        gps.append(int(runner.state.gps_count))
    return runner, results, iters, loops, gps, cycles, corrected


def bag_missions():
    """Both bags written by the port's writer, replayed by the JAX package;
    writes BAG_OUT."""
    import collections
    import hashlib
    import shutil
    import tempfile

    from lio_slam_tpu.io import rosbag as jrb
    from lio_slam_tpu_torch.io.synthetic_bag import write_synthetic_bag

    tmp = tempfile.mkdtemp()
    out = {}
    try:
        for key, kw in (("", sm.bag_mission_bag_kwargs()),
                        ("hostile_", sm.hostile_bag_kwargs())):
            path = os.path.join(tmp, f"{key or 'mission_'}in.bag")
            truth = write_synthetic_bag(path, **kw)
            out[key + "bag_sha256"] = np.array(
                hashlib.sha256(open(path, "rb").read()).hexdigest())
            out[key + "bag_bytes"] = np.int64(os.path.getsize(path))
            t0 = time.time()
            if key:
                runner, results, iters, loops, gps, cycles, corrected = \
                    replay_jax_bag(sm.hostile_bag_config(), path,
                                   sm.HOSTILE_TOPICS)
            else:
                rec = os.path.join(tmp, "recorded.bag")
                runner, results, iters, loops, gps, cycles, corrected = \
                    replay_jax_bag(sm.loop_mission_config(), path,
                                   sm.BAG_TOPICS, loop_every=sm.LOOP_EVERY,
                                   record_bag=rec)
                runner.close()
                topics = collections.Counter(
                    m.topic for m in jrb.BagReader(rec).read_messages())
                out["recorded_topics"] = np.array(sorted(topics))
                out["recorded_counts"] = np.array(
                    [topics[k] for k in sorted(topics)], np.int32)
                cyc = lambda k: np.stack([c[k] for c in cycles])
                out.update(cycle_scan=np.array([c["scan"] for c in cycles],
                                               np.int32),
                           loop_accepted=cyc("loop_accepted"),
                           loop_pair_j=cyc("loop_pair_j"),
                           loop_count=np.array(loops, np.int32),
                           full_correction_scans=np.array(corrected, np.int32),
                           keyframes=np.int32(int(runner.state.store.count)))
            poses = np.stack([r.pose for r in results]).astype(np.float32)
            rel = np.stack([np.asarray(jse3.pose6_between(truth.poses[0], p))
                            for p in truth.poses])
            ate = synthetic.ate_rmse(poses, rel)
            out.update({key + "poses": poses,
                        key + "is_keyframe": np.array([r.is_keyframe
                                                       for r in results]),
                        key + "registration_iters": np.array(iters, np.int32),
                        key + "gps_count": np.array(gps, np.int32),
                        key + "ate_rmse_m": np.float32(ate)})
            print(f"{key or 'mission_'}bag: {len(results)} scans, "
                  f"{sum(r.is_keyframe for r in results)} keyframes, "
                  f"{sum(iters)} GN iterations of mapping, {loops[-1]} loop "
                  f"factors, {gps[-1]} GPS factors, full corrections at "
                  f"{corrected}, ATE {ate:.5f} m, {time.time() - t0:.1f} s; "
                  f"bag {out[key + 'bag_bytes']} B sha256 "
                  f"{out[key + 'bag_sha256']}")
        print("recorded bag:", dict(zip(out["recorded_topics"].tolist(),
                                         out["recorded_counts"].tolist())))
    finally:
        shutil.rmtree(tmp)
    np.savez(BAG_OUT, **out)
    print(f"wrote {BAG_OUT}")


def smoke_mission():
    """The JAX `Runner` over the 40-scan smoke mission; writes OUT."""
    cfg = sm.bench_config()
    seq = synthetic.make_sequence(n_scans=sm.SMOKE_SCANS,
                                  n_points=sm.SMOKE_POINTS,
                                  seed=sm.SMOKE_SEED, speed=sm.SMOKE_SPEED)
    scans, imus = sm.synthetic_inputs(seq, cfg)
    runner = Runner(to_jax_config(cfg, jax_config))
    iters = count_iterations(runner)
    t0 = time.time()
    results, imu_states = [], []
    for i in range(len(scans)):
        imu_states.append(jax.tree.map(np.array, runner.imu_state))
        results.append(runner.process_scan(scans[i], imu=imus[i]))
    poses = np.stack([r.pose for r in results]).astype(np.float32)
    ate = synthetic.ate_rmse(poses, sm.relative_truth(seq))
    stack = lambda f: np.stack([f(s) for s in imu_states])
    np.savez(OUT, poses=poses,
             is_keyframe=np.array([r.is_keyframe for r in results]),
             registration_iters=np.array(iters, np.int32),
             keyframes=np.int32(int(runner.state.store.count)),
             ate_rmse_m=np.float32(ate),
             imu_R=stack(lambda s: s.nav.R), imu_p=stack(lambda s: s.nav.p),
             imu_v=stack(lambda s: s.nav.v),
             imu_bias_gyr=stack(lambda s: s.bias_gyr),
             imu_bias_acc=stack(lambda s: s.bias_acc),
             imu_cov=stack(lambda s: s.cov),
             imu_initialized=stack(lambda s: s.initialized),
             imu_failure=stack(lambda s: s.failure))
    print(f"wrote {OUT}: {len(results)} scans, "
          f"{int(runner.state.store.count)} keyframes, ATE {ate:.5f} m, "
          f"{sum(iters)} GN iterations, {time.time() - t0:.1f} s")


def corner_missions():
    """The JAX `Runner` over the port's corner missions (the incremental
    and the rebuild-mode map); writes CORNER_OUT and REBUILD_OUT."""
    for mode, n_scans, out in (("incremental", sm.CORNER_SCANS, CORNER_OUT),
                               ("rebuild", sm.REBUILD_SCANS, REBUILD_OUT)):
        cfg = sm.corner_mission_config(mode)
        seq, scans, imus = sm.corner_mission_inputs(cfg, n_scans=n_scans)
        runner = Runner(to_jax_config(cfg, jax_config))
        iters = count_iterations(runner)
        t0 = time.time()
        results = [runner.process_scan(scans[i], imu=imus[i])
                   for i in range(len(scans))]
        poses = np.stack([r.pose for r in results]).astype(np.float32)
        ate = synthetic.ate_rmse(poses, sm.relative_truth(seq))
        n_kf = int(runner.state.store.count)
        corners = np.array(runner.state.store.corner_masks[:n_kf]).sum(1)
        np.savez(out, scans_sha256=np.array(sm.scans_sha256(scans)),
                 poses=poses,
                 is_keyframe=np.array([r.is_keyframe for r in results]),
                 registration_iters=np.array(iters, np.int32),
                 keyframes=np.int32(n_kf), corners=corners.astype(np.int32),
                 ate_rmse_m=np.float32(ate))
        print(f"wrote {out}: {mode} map, {len(results)} scans, {n_kf} "
              f"keyframes, corners a keyframe {corners.tolist()}, ATE "
              f"{ate:.5f} m, {sum(iters)} GN iterations, "
              f"{time.time() - t0:.1f} s")


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in ("smoke", "loop", "archive", "bag", "corner", "all"):
        sys.exit(__doc__)
    jreg._maybe_fused = jax_fused_interpret
    if which in ("smoke", "all"):
        smoke_mission()
    if which in ("loop", "all"):
        loop_mission()
    if which in ("archive", "all"):
        archive_mission()
    if which in ("bag", "all"):
        with repaired_jax_feed():
            bag_missions()
    if which in ("corner", "all"):
        corner_missions()


if __name__ == "__main__":
    main()
