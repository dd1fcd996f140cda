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
- `hard_replay_jax.npz`: the JAX `HostDrivenReplay` (`loop_every=10`)
  over the port's hard-tier replay (`hard_replay_config()`, the "default"
  preset at full width; 60 sweep scans of `hard_replay_inputs()` with 2 %
  garbage returns and 20000 clutter points): the inputs' sha256, per-scan
  poses, GN iterations, degenerate flags and TransformFusion output, the
  IMU front-end state each scan starts from, the loop count, each detector
  cycle's accepted flags and fitness, each scan's GN trace (the pose and
  inlier count each iteration starts from, the final pose; recorded by
  `jax.debug.callback` in the traced loop); and the
  ATEs of the deskew mission (`deskew_mission_inputs()`) replayed with its
  point times and with zeros.

- `sharded_mission_jax.npz`: the JAX `Runner` with a mesh of 1 and of 2
  virtual CPU devices (`make_mesh(D)`, keys prefixed `d1_` / `d2_`) over
  the sharded mission of chip_smoke.py phase 18
  (`sharded_mission_config(D)`: bench.py's widths, 32768 buckets split
  over the devices, the sparse full solver): 40 scans of the smoke
  mission's sequence with its IMU windows, then a loop constraint injected
  between the newest keyframe and keyframe 0 (information 1e2) and scans
  fed until the full correction has run: per-scan poses, keyframe flags and
  GN iterations, the keyframe count before and after, the scan of the
  correction, and each device's rows in use at the end.

- `sharded_halos_jax.npz` (`sharded_halos`): the JAX sharded registers
  (`parallel/registration.make_sharded_register` and
  `make_map_sharded_register`, a 2-device mesh) at halos "xy", "full" and
  "none" on tests/test_torch_sharding.py's problem: pose and GN
  iterations, with the inputs' sha256 and each configuration; and the
  JAX sharded mission (`parallel/mission.make_sharded_mission`) at halo
  "xy" over tests/test_torch_sharded_mission.py's 12 scans: poses and
  each device's rows in use, with the scans' sha256 (about 1 minute).

- `pipeline_replay_jax.npz`: the JAX `make_pipeline_replay(loop_every=10)`
  (the whole pipeline in one `lax.scan`) over bench.py part 1b's inputs
  (`pipeline_replay_inputs()`: `bench_config()`, 120 scans of 32768
  points, 64-sample IMU windows): the inputs' sha256, per-scan poses, GN
  iterations, degenerate flags and TransformFusion output, the loop and
  keyframe counts, the IMU front-end state each scan starts from and each
  scan's GN trace as in `hard_replay_jax.npz` (both recorded by
  `jax.debug.callback` in the scan body, which leaves the replay's numbers
  bit-equal).
  Beside them (`rebuild`), the monolith on the rebuild-mode map: keys
  prefixed `rebuild_` over the first 40 of those scans at
  `rebuild_replay_config()` (chip_smoke.py phase 21), and keys prefixed
  `small_rebuild_`, 8 scans of 2048 points at tests/test_replay.py's
  config (tests/test_torch_resident_modes.py): per-scan poses, GN iterations,
  degenerate flags, TransformFusion output, the IMU front-end state each
  scan starts from, the keyframe count (and at full width the GN traces).
- `loop_replay_jax.npz`: the JAX `ChunkedReplay(loop_every=10)` over the
  loop mission's circle (`loop_replay_inputs()`: `loop_mission_config()`,
  130 scans, no GPS in a replay): the same per-scan keys, the loop count
  after each chunk, each detector cycle's accepted flags and the scans of
  the full corrections (a chunk's last scan, where the flag was up).

- `layout_missions_jax.npz`: the JAX `Runner` over the smoke mission's 40
  scans under each of chip_smoke.py phase 20's configurations
  (`synthetic_mission.LAYOUT_MISSIONS` through `layout_mission_config`:
  halo "xy" at a cap of 72, "full" at 128, "none" at 24, and "z" at 24 with
  the cell-sorted scan and the hash downsample), keys prefixed with the
  mission's name: what `smoke_mission_jax.npz` holds.  Beside them, keys
  prefixed `small_<name>_`, the same configurations at the narrow widths of
  `torch_port_helpers.small_config` over 5 scans of 2048 points
  (tests/test_torch_gather_layouts.py): per-scan poses, keyframe flags, GN
  iterations, the IMU front-end state each scan starts from, the keyframe
  count and the grid's counts at the end.

On the CPU the JAX registration takes its unfused path, which finds fresh
correspondences at every GN iteration whatever `corr_refresh_every` says
(`registration._maybe_fused` returns None there).  The mission runs
`corr_refresh_every=2`, so this script gives the registration the fused
path it takes off the CPU, with the Pallas kernel in interpret mode and the
candidate block held between refreshes, as the port does.

Run by hand from the repository root (`smoke`, `loop`, `archive`, `bag`,
`corner`, `hard`, `sharded`, `replay`, `rebuild`, `layouts`, or all ten
when no argument is given):

    python tests/torch_port_make_fixture.py \
        [smoke|loop|archive|bag|corner|hard|sharded|replay|rebuild|layouts]

It is not a test (pytest does not collect it).
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# two virtual CPU devices for the sharded mission's 2-device mesh
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=2"

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
import torch_port_helpers as H  # noqa: E402
from torch_port_helpers import (jax_fused_interpret, record_imu_states,  # noqa: E402
                                repaired_jax_feed, small_layout_config,
                                small_rebuild_inputs, to_jax_config)

FIXTURES = os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures")
OUT = os.path.join(FIXTURES, "smoke_mission_jax.npz")
LOOP_OUT = os.path.join(FIXTURES, "loop_mission_jax.npz")
ARCHIVE_OUT = os.path.join(FIXTURES, "archive_mission_jax.npz")
BAG_OUT = os.path.join(FIXTURES, "bag_mission_jax.npz")
CORNER_OUT = os.path.join(FIXTURES, "corner_mission_jax.npz")
REBUILD_OUT = os.path.join(FIXTURES, "rebuild_mission_jax.npz")
HARD_OUT = os.path.join(FIXTURES, "hard_replay_jax.npz")
SHARDED_OUT = os.path.join(FIXTURES, "sharded_mission_jax.npz")
PIPELINE_OUT = os.path.join(FIXTURES, "pipeline_replay_jax.npz")
LOOP_REPLAY_OUT = os.path.join(FIXTURES, "loop_replay_jax.npz")
LAYOUT_OUT = os.path.join(FIXTURES, "layout_missions_jax.npz")
SHARDED_HALOS_OUT = os.path.join(FIXTURES, "sharded_halos_jax.npz")
SMALL_LAYOUT_SCANS = 5          # tests/test_torch_gather_layouts.py's missions
SMALL_LAYOUT_POINTS = 2048


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


def runner_mission(cfg, seq) -> tuple:
    """(keys, runner): the JAX `Runner` over `seq` with `cfg`: per-scan
    poses, keyframe flags, GN iterations and the IMU front-end state each
    scan starts from, the keyframe count and the ATE against truth."""
    scans, imus = sm.synthetic_inputs(seq, cfg)
    runner = Runner(to_jax_config(cfg, jax_config))
    iters = count_iterations(runner)
    imu_states = record_imu_states(runner)
    results = [runner.process_scan(scans[i], imu=imus[i])
               for i in range(len(scans))]
    poses = np.stack([r.pose for r in results]).astype(np.float32)
    stack = lambda f: np.stack([f(s) for s in imu_states])
    return dict(poses=poses,
                is_keyframe=np.array([r.is_keyframe for r in results]),
                registration_iters=np.array(iters, np.int32),
                keyframes=np.int32(int(runner.state.store.count)),
                ate_rmse_m=np.float32(synthetic.ate_rmse(
                    poses, sm.relative_truth(seq))),
                imu_R=stack(lambda s: s.nav.R), imu_p=stack(lambda s: s.nav.p),
                imu_v=stack(lambda s: s.nav.v),
                imu_bias_gyr=stack(lambda s: s.bias_gyr),
                imu_bias_acc=stack(lambda s: s.bias_acc),
                imu_cov=stack(lambda s: s.cov),
                imu_initialized=stack(lambda s: s.initialized),
                imu_failure=stack(lambda s: s.failure)), runner


def smoke_sequence():
    return synthetic.make_sequence(n_scans=sm.SMOKE_SCANS,
                                   n_points=sm.SMOKE_POINTS,
                                   seed=sm.SMOKE_SEED, speed=sm.SMOKE_SPEED)


def smoke_mission():
    """The JAX `Runner` over the 40-scan smoke mission; writes OUT."""
    t0 = time.time()
    out, _ = runner_mission(sm.bench_config(), smoke_sequence())
    np.savez(OUT, **out)
    print(f"wrote {OUT}: {len(out['poses'])} scans, {int(out['keyframes'])} "
          f"keyframes, ATE {float(out['ate_rmse_m']):.5f} m, "
          f"{int(out['registration_iters'].sum())} GN iterations, "
          f"{time.time() - t0:.1f} s")


def layout_missions():
    """The JAX `Runner` over phase 20's missions at full width and at the
    narrow widths of the CPU tests; writes LAYOUT_OUT."""
    keys = {}
    small_seq = synthetic.make_sequence(n_scans=SMALL_LAYOUT_SCANS,
                                        n_points=SMALL_LAYOUT_POINTS, seed=0)
    for name, halo, cap, srt, ds in sm.LAYOUT_MISSIONS:
        t0 = time.time()
        cfg = sm.layout_mission_config(halo, cap, srt, ds)
        out, _ = runner_mission(cfg, smoke_sequence())
        keys.update({f"{name}_{k}": v for k, v in out.items()})
        print(f"{name}: {int(out['keyframes'])} keyframes, ATE "
              f"{float(out['ate_rmse_m']):.5f} m, "
              f"{int(out['registration_iters'].sum())} GN iterations, "
              f"{time.time() - t0:.1f} s", flush=True)
        out, runner = runner_mission(small_layout_config(name), small_seq)
        out["grid_counts"] = np.array(runner.state.map_grid.counts)
        keys.update({f"small_{name}_{k}": v for k, v in out.items()})
    np.savez_compressed(LAYOUT_OUT, **keys)
    print(f"wrote {LAYOUT_OUT}")


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


def recording_gn_loop(gn_loop, scans):
    """`registration._gn_loop` for a trace that calls back with the pose
    and the inlier count each GN iteration starts from, then the final
    pose, into `scans[-1]` (the fused path, with or without the candidate
    refresh of `corr_refresh_every > 1`)."""
    def note(pose, n_inl):
        scans[-1].append((np.array(pose), int(n_inl)))

    def wrapped(scan, scan_mask, corr_fn, init_pose6, cfg, runnable,
                min_correspondences, ne_fn=None):
        if isinstance(ne_fn, tuple):
            gather_fn, from_cand_fn, refresh = ne_fn

            def from_cand_noting(cand, hh, pose):
                ne = from_cand_fn(cand, hh, pose)
                jax.debug.callback(note, pose, ne[2], ordered=True)
                return ne
            noting = (gather_fn, from_cand_noting, refresh)
        else:
            def noting(pose):
                ne = ne_fn(pose)
                jax.debug.callback(note, pose, ne[2], ordered=True)
                return ne

        res = gn_loop(scan, scan_mask, corr_fn, init_pose6, cfg, runnable,
                      min_correspondences, ne_fn=noting)
        jax.debug.callback(note, res.pose, -1, ordered=True)
        return res
    return wrapped


def padded_traces(gn, iters, cap):
    """Each scan's mapping GN trace of `gn` (its first loop), padded:
    (poses (S, cap + 1, 6), the pose each iteration started from, then the
    final pose, NaN after; inliers (S, cap) of each iteration, -1 after)."""
    gn_poses = np.full((len(gn), cap + 1, 6), np.nan, np.float32)
    gn_inliers = np.full((len(gn), cap), -1, np.int32)
    for k, loops in enumerate(gn):
        trace = loops[:iters[k] + 1]
        assert len(trace) == iters[k] + 1 and trace[-1][1] == -1, (
            k, len(trace), iters[k])
        gn_poses[k, :len(trace)] = [p for p, _ in trace]
        gn_inliers[k, :iters[k]] = [c for _, c in trace[:-1]]
    return gn_poses, gn_inliers


def jax_replay(cfg, batch, loop_every, gn=None):
    """(final state, ReplayOut, detector cycles, the front-end's state
    before each scan) of the JAX `HostDrivenReplay` over a numpy
    `ReplayBatch` of the port.  With a list `gn`, each scan's mapping step
    appends to it the (pose, inliers) each GN iteration started from and
    the final pose (inliers -1)."""
    import jax.numpy as jnp

    from lio_slam_tpu.pipeline import replay as jreplay

    hd = jreplay.HostDrivenReplay(to_jax_config(cfg, jax_config),
                                  loop_every=loop_every)
    cycles, imu_states = [], []
    detector = hd.detector
    prep_predict = hd._prep_predict
    step = hd.step

    def watching_detector(state):
        state, aux = detector(state)
        cycles.append({k: np.array(v) for k, v in aux.items()})
        return state, aux

    def watching_prep(fes, *args):
        imu_states.append(jax.tree.map(np.asarray, fes))
        return prep_predict(fes, *args)

    def recording_step(state, inp):
        gn.append([])
        state, out = step(state, inp)
        jax.effects_barrier()
        return state, out

    hd.detector = watching_detector
    hd._prep_predict = watching_prep
    if gn is not None:
        hd.step = recording_step
        gn_loop, jreg._gn_loop = jreg._gn_loop, recording_gn_loop(jreg._gn_loop,
                                                                  gn)
    try:
        state, fes = hd.init()
        state, _, outs = hd.run(state, fes, hd.split(jreplay.ReplayBatch(
            *(jnp.asarray(a) for a in batch))))
    finally:
        if gn is not None:
            jreg._gn_loop = gn_loop
    return state, outs, cycles, imu_states


def hard_replay():
    """The JAX `HostDrivenReplay` over the port's hard-tier inputs and over
    the deskew mission; writes HARD_OUT."""
    t0 = time.time()
    cfg = sm.hard_replay_config()
    seq, batch = sm.hard_replay_inputs(cfg)
    gn = []
    state, outs, cycles, imu = jax_replay(cfg, batch, sm.HARD_LOOP_EVERY, gn)
    poses = np.asarray(outs.poses, np.float32)
    iters = np.asarray(outs.iters, np.int32)
    gn_poses, gn_inliers = padded_traces(gn, iters,
                                         cfg.registration.max_iterations)
    ate = synthetic.ate_rmse(poses, sm.relative_truth(seq))
    cyc = lambda k: np.stack([c[k] for c in cycles])
    stack = lambda get: np.stack([get(f) for f in imu])
    t1 = time.time()

    dcfg, dseq, windows = sm.deskew_mission_inputs()
    ates = []
    for ptimes in (None, np.zeros_like(dseq.ptimes)):
        _, douts, _, _ = jax_replay(dcfg, sm.replay_batch(dseq, windows,
                                                          ptimes), 0)
        ates.append(synthetic.ate_rmse(np.asarray(douts.poses),
                                       sm.relative_truth(dseq)))
    np.savez(HARD_OUT, batch_sha256=np.array(sm.batch_sha256(batch)),
             poses=poses, registration_iters=iters,
             degenerate=np.asarray(outs.degenerate),
             fused_last=np.asarray(outs.fused_last, np.float32),
             loop_count=np.int32(state.loop_count),
             keyframes=np.int32(state.store.count),
             loop_accepted=cyc("loop_accepted"), loop_fitness=cyc("loop_fitness"),
             ate_rmse_m=np.float32(ate),
             imu_R=stack(lambda f: f.nav.R), imu_p=stack(lambda f: f.nav.p),
             imu_v=stack(lambda f: f.nav.v),
             imu_bias_gyr=stack(lambda f: f.bias_gyr),
             imu_bias_acc=stack(lambda f: f.bias_acc),
             imu_cov=stack(lambda f: f.cov),
             imu_initialized=stack(lambda f: f.initialized),
             imu_failure=stack(lambda f: f.failure),
             gn_poses=gn_poses, gn_inliers=gn_inliers,
             deskew_ate_with_m=np.float32(ates[0]),
             deskew_ate_without_m=np.float32(ates[1]))
    print(f"wrote {HARD_OUT}: {len(poses)} scans, "
          f"{int(state.store.count)} keyframes, {int(state.loop_count)} loops, "
          f"ATE {ate:.5f} m, {int(iters.sum())} GN iterations (mean over "
          f"scans 1-59 {iters[1:].mean():.2f}), degenerate at "
          f"{np.nonzero(np.asarray(outs.degenerate))[0].tolist()}, cycles' "
          f"fitness {cyc('loop_fitness').tolist()}, {t1 - t0:.1f} s; deskew "
          f"mission ATE {ates[0]:.5f} m with point times, {ates[1]:.5f} m "
          f"without, {time.time() - t1:.1f} s")


def sharded_mission():
    """The JAX `Runner` with a mesh of 1 and of 2 devices over the sharded
    mission; writes SHARDED_OUT."""
    from lio_slam_tpu.parallel import mesh as jax_mesh

    seq = synthetic.make_sequence(n_scans=sm.SHARDED_SCANS + sm.SHARDED_TAIL,
                                  n_points=sm.SMOKE_POINTS, seed=sm.SMOKE_SEED,
                                  speed=sm.SMOKE_SPEED)
    out = {}
    for D in (1, 2):
        t0 = time.time()
        cfg = to_jax_config(sm.sharded_mission_config(D), jax_config)
        scans, imus = sm.synthetic_inputs(seq, sm.sharded_mission_config(D))
        runner = Runner(cfg, mesh=jax_mesh.make_mesh(D))
        iters = count_iterations(runner)
        corrected = []
        full_correct = runner.full_correct

        def watching_correct(state):
            if bool(state.needs_full_solve):
                corrected.append(runner.scan_count)
            return full_correct(state)

        runner.full_correct = watching_correct
        results = [runner.process_scan(scans[i], imu=imus[i])
                   for i in range(sm.SHARDED_SCANS)]
        st = runner.state
        n_kf = int(st.store.count)
        meas = np.asarray(jse3.pose6_between(st.store.poses[n_kf - 1],
                                             st.store.poses[0]))
        if not runner.inject_loop_constraint(n_kf - 1, 0, meas,
                                             np.full(6, 1e2, np.float32)):
            raise RuntimeError("the injected loop was refused")
        i = sm.SHARDED_SCANS
        while not corrected and i < len(scans):
            results.append(runner.process_scan(scans[i], imu=imus[i]))
            i += 1
        if not corrected:
            raise RuntimeError("no full correction after the injected loop")
        T = cfg.registration.grid_table_size
        rows = np.asarray(runner.state.map_grid.counts).reshape(D, T).sum(1)
        out.update({
            f"d{D}_poses": np.stack([r.pose for r in results]).astype(
                np.float32),
            f"d{D}_is_keyframe": np.array([r.is_keyframe for r in results]),
            f"d{D}_registration_iters": np.array(iters, np.int32),
            f"d{D}_keyframes_before": np.int32(n_kf),
            f"d{D}_keyframes": np.int32(int(runner.state.store.count)),
            f"d{D}_correction_scan": np.int32(corrected[0]),
            f"d{D}_rows": rows.astype(np.int64)})
        print(f"sharded mission on {D} device(s): {len(results)} scans, "
              f"{n_kf} -> {int(runner.state.store.count)} keyframes, full "
              f"correction at scan {corrected[0]}, rows a device "
              f"{rows.tolist()}, {sum(iters)} GN iterations, "
              f"{time.time() - t0:.1f} s")
    np.savez(SHARDED_OUT, **out)
    print(f"wrote {SHARDED_OUT}")


def sharded_halos():
    """The JAX package's sharded registers at halos "xy", "full" and
    "none" on tests/test_torch_sharding.py's problem, and its sharded
    mission at halo "xy" over tests/test_torch_sharded_mission.py's 12
    scans, each on a 2-device mesh; writes SHARDED_HALOS_OUT."""
    import jax.numpy as jnp

    import test_torch_sharded_mission as tm
    import test_torch_sharding as ts
    from lio_slam_tpu.parallel import mesh as jax_mesh
    from lio_slam_tpu.parallel import mission as jax_pmission
    from lio_slam_tpu.parallel import registration as jax_preg

    t0 = time.time()
    mesh = jax_mesh.make_mesh(ts.HALO_D)
    base = ts.problem()
    scan, smask, mp, mmask, truth = base
    sh = lambda x: jax_mesh.shard_points(mesh, jnp.asarray(x))
    init = jnp.asarray(truth + ts.INIT_OFFSET)
    keys = {"register_inputs_sha256": np.array(ts.halo_inputs_sha256(base))}
    for halo in ts.HALOS:
        cfg = ts.reg_cfgs(**ts.halo_cfg(halo))[1]
        keys[f"register_{halo}_cfg"] = np.array(repr(ts.halo_cfg(halo)))
        runs = {
            "sharded_register": lambda: jax_preg.make_sharded_register(
                mesh, cfg)(sh(scan), sh(smask), jnp.asarray(mp),
                           jnp.asarray(mmask), init),
            "map_sharded_register": lambda: jax_preg.make_map_sharded_register(
                mesh, cfg)(jnp.asarray(scan), jnp.asarray(smask), sh(mp),
                           sh(mmask), init)}
        for kind, run in runs.items():
            res = run()
            keys[f"{kind}_{halo}_pose"] = np.asarray(res.pose, np.float32)
            keys[f"{kind}_{halo}_iterations"] = np.int32(res.iterations)
            print(f"{kind} at halo {halo}: {int(res.iterations)} GN "
                  f"iterations, {np.abs(np.asarray(res.pose) - truth).max():.3e}"
                  f" from truth", flush=True)
    seq = tm.make_seq()
    cfg = tm.mission_config(jax_config, tm.HALO, tm.HALO_CAP)
    init_fn, step = jax_pmission.make_sharded_mission(
        jax_mesh.make_mesh(2), cfg)[:2]
    state, poses, _ = tm._jax_run(seq, tm.N_SCANS, step, init_fn())
    rows = np.asarray(state.map_grid.counts).reshape(2, tm.T_LOCAL).sum(1)
    keys.update({
        "mission_xy_seq_sha256": np.array(H.arrays_sha256(
            *(seq[k] for k in sorted(seq)))),
        "mission_xy_cfg": np.array(repr(cfg)),
        "mission_xy_poses": poses.astype(np.float32),
        "mission_xy_rows": rows.astype(np.int64)})
    np.savez(SHARDED_HALOS_OUT, **keys)
    print(f"mission at halo {tm.HALO}: rows a device {rows.tolist()}; wrote "
          f"{SHARDED_HALOS_OUT} in {time.time() - t0:.1f} s")


def replay_outputs(outs) -> dict:
    """The per-scan keys a replay fixture holds."""
    return dict(poses=np.asarray(outs.poses, np.float32),
                registration_iters=np.asarray(outs.iters, np.int32),
                degenerate=np.asarray(outs.degenerate),
                fused_last=np.asarray(outs.fused_last, np.float32))


def jax_monolith(cfg, batch, loop_every, traces=True):
    """(final state, outputs) of the JAX `make_pipeline_replay(loop_every)`
    (the whole pipeline in one `lax.scan`) over a numpy `ReplayBatch` of
    the port: `replay_outputs`' keys, the IMU front-end state each scan
    starts from (`imu_*`) and, with `traces` (the fused path only), each
    scan's GN trace (`gn_poses`, `gn_inliers`), all recorded by
    `jax.debug.callback` in the scan body, which leaves the replay's
    numbers bit-equal."""
    import jax.numpy as jnp

    from lio_slam_tpu.pipeline import imu_frontend as jfe
    from lio_slam_tpu.pipeline import lio as jlio
    from lio_slam_tpu.pipeline import replay as jreplay

    jcfg = to_jax_config(cfg, jax_config)
    imu, gn = [], []

    def note(fes):
        imu.append(jax.tree.map(np.array, fes))
        gn.append([])

    def recording_frontend(imu_cfg):
        correct, predict_rate, transform_fusion = make_frontend(imu_cfg)

        def predicting(fes, *args):
            jax.debug.callback(note, fes, ordered=True)
            return predict_rate(fes, *args)
        return correct, predicting, transform_fusion

    make_frontend = jreplay.fe.make_frontend
    jreplay.fe.make_frontend = recording_frontend
    gn_loop = jreg._gn_loop
    if traces:
        jreg._gn_loop = recording_gn_loop(gn_loop, gn)
    try:
        run = jreplay.make_pipeline_replay(jcfg, loop_every=loop_every)
        state, _, outs = run(jlio.init_state(jcfg), jfe.init_state(),
                             jreplay.ReplayBatch(*(jnp.asarray(a)
                                                   for a in batch)))
        jax.effects_barrier()
    finally:
        jreplay.fe.make_frontend = make_frontend
        jreg._gn_loop = gn_loop
    assert len(imu) == len(batch.stamp), len(imu)
    stack = lambda get: np.stack([get(f) for f in imu])
    out = replay_outputs(outs)
    out.update(imu_R=stack(lambda f: f.nav.R), imu_p=stack(lambda f: f.nav.p),
               imu_v=stack(lambda f: f.nav.v),
               imu_bias_gyr=stack(lambda f: f.bias_gyr),
               imu_bias_acc=stack(lambda f: f.bias_acc),
               imu_cov=stack(lambda f: f.cov),
               imu_initialized=stack(lambda f: f.initialized),
               imu_failure=stack(lambda f: f.failure))
    if traces:
        out["gn_poses"], out["gn_inliers"] = padded_traces(
            gn, out["registration_iters"], cfg.registration.max_iterations)
    return state, out


def save_merged(path, keys: dict):
    """Write `keys` into the npz at `path`, keeping its other keys."""
    old = dict(np.load(path)) if os.path.exists(path) else {}
    old.update(keys)
    np.savez(path, **old)


def pipeline_replays():
    """The JAX scan programs over phase 19's inputs; writes PIPELINE_OUT
    (its keys of `rebuild_replays` kept) and LOOP_REPLAY_OUT."""
    import jax.numpy as jnp

    from lio_slam_tpu.pipeline import replay as jreplay

    t0 = time.time()
    cfg = sm.bench_config()
    seq, batch = sm.pipeline_replay_inputs()
    state, out = jax_monolith(cfg, batch, sm.LOOP_EVERY)
    truth = sm.relative_truth(seq)
    drift = float(np.linalg.norm(out["poses"][-1, 3:] - truth[-1, 3:]))
    save_merged(PIPELINE_OUT, dict(
        batch_sha256=np.array(sm.batch_sha256(batch)),
        loop_count=np.int32(state.loop_count),
        keyframes=np.int32(state.store.count), drift_m=np.float32(drift),
        ate_rmse_m=np.float32(synthetic.ate_rmse(out["poses"], truth)),
        **out))
    print(f"wrote {PIPELINE_OUT}: {len(out['poses'])} scans, "
          f"{int(state.store.count)} keyframes, {int(state.loop_count)} loops, "
          f"drift {drift:.4f} m, {int(out['registration_iters'].sum())} GN "
          f"iterations, degenerate at "
          f"{np.nonzero(out['degenerate'])[0].tolist()}, {time.time() - t0:.1f} s")

    t0 = time.time()
    cfg = sm.loop_mission_config()
    seq, batch = sm.loop_replay_inputs()
    cr = jreplay.ChunkedReplay(to_jax_config(cfg, jax_config),
                               loop_every=sm.LOOP_EVERY)
    cycles, corrected, loops = [], [], []
    detector, full_correct = cr.detector, cr.full_correct

    def watching_detector(state):
        state, aux = detector(state)
        cycles.append({k: np.array(v) for k, v in aux.items()})
        return state, aux

    def watching_correct(state):
        if bool(state.needs_full_solve):
            corrected.append(len(cycles) * sm.LOOP_EVERY - 1)
        state = full_correct(state)
        loops.append(int(state.loop_count))
        return state

    cr.detector, cr.full_correct = watching_detector, watching_correct
    state, fes = cr.init()
    state, _, outs = cr.run(state, fes, cr.split(jreplay.ReplayBatch(
        *(jnp.asarray(a) for a in batch))))
    out = replay_outputs(outs)
    cyc = lambda k: np.stack([c[k] for c in cycles])
    np.savez(LOOP_REPLAY_OUT, batch_sha256=np.array(sm.batch_sha256(batch)),
             loop_count=np.array(loops, np.int32),
             keyframes=np.int32(state.store.count),
             full_correction_scans=np.array(corrected, np.int32),
             loop_accepted=cyc("loop_accepted"),
             loop_fitness=cyc("loop_fitness"),
             ate_rmse_m=np.float32(synthetic.ate_rmse(
                 out["poses"], sm.relative_truth(seq))), **out)
    print(f"wrote {LOOP_REPLAY_OUT}: {len(out['poses'])} scans, "
          f"{int(state.store.count)} keyframes, loops after each chunk "
          f"{loops}, full corrections at scans {corrected}, accepted "
          f"{cyc('loop_accepted').tolist()}, {int(out['registration_iters'].sum())} "
          f"GN iterations, {time.time() - t0:.1f} s")


def rebuild_replays():
    """The JAX monolith on the rebuild-mode map: phase 21's first
    REBUILD_REPLAY_SCANS scans of phase 19's inputs at
    `rebuild_replay_config()` (keys `rebuild_`), and the small replay of
    tests/test_torch_resident_modes.py (keys `small_rebuild_`); merged into
    PIPELINE_OUT."""
    t0 = time.time()
    cfg, batch = small_rebuild_inputs()
    state, out = jax_monolith(cfg, batch, H.SMALL_REBUILD_LOOP_EVERY,
                              traces=False)
    keys = {"small_rebuild_" + k: v for k, v in out.items()}
    keys.update(small_rebuild_keyframes=np.int32(state.store.count),
                small_rebuild_batch_sha256=np.array(sm.batch_sha256(batch)))
    print(f"small rebuild replay: {len(out['poses'])} scans, "
          f"{int(state.store.count)} keyframes, GN iterations "
          f"{out['registration_iters'].tolist()}, {time.time() - t0:.1f} s")
    t0 = time.time()
    cfg = sm.rebuild_replay_config()
    seq, batch = sm.pipeline_replay_inputs(n_scans=sm.REBUILD_REPLAY_SCANS)
    state, out = jax_monolith(cfg, batch, sm.LOOP_EVERY)
    truth = sm.relative_truth(seq)
    keys.update({"rebuild_" + k: v for k, v in out.items()})
    keys.update(rebuild_batch_sha256=np.array(sm.batch_sha256(batch)),
                rebuild_keyframes=np.int32(state.store.count),
                rebuild_loop_count=np.int32(state.loop_count),
                rebuild_ate_rmse_m=np.float32(synthetic.ate_rmse(out["poses"],
                                                                 truth)))
    save_merged(PIPELINE_OUT, keys)
    print(f"wrote the rebuild keys into {PIPELINE_OUT}: {len(out['poses'])} "
          f"scans, {int(state.store.count)} keyframes, "
          f"{int(out['registration_iters'].sum())} GN iterations, degenerate "
          f"at {np.nonzero(out['degenerate'])[0].tolist()}, ATE "
          f"{float(keys['rebuild_ate_rmse_m']):.5f} m, {time.time() - t0:.1f} s")


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in ("smoke", "loop", "archive", "bag", "corner", "hard",
                     "sharded", "sharded_halos", "replay", "rebuild",
                     "layouts", "all"):
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
    if which in ("hard", "all"):
        hard_replay()
    if which in ("sharded", "all"):
        sharded_mission()
    if which in ("sharded_halos", "all"):
        sharded_halos()
    if which in ("replay", "all"):
        pipeline_replays()
    if which in ("rebuild", "all"):
        rebuild_replays()
    if which in ("layouts", "all"):
        layout_missions()


if __name__ == "__main__":
    main()
