"""Inputs and configuration of the synthetic missions the port is run and
checked on: the runner CLI, `chip_smoke.py`, the parity tests and the
fixture script all build their scans and IMU windows here, so every side
of a comparison sees the same numbers.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from lio_slam_tpu_torch.config import (Config, GpsConfig, ImuConfig,
                                       KeyframeConfig, LoopClosureConfig,
                                       RegistrationConfig, StaticConfig,
                                       get_config)
from lio_slam_tpu_torch.io import formats
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.io.synthetic import SyntheticSequence
from lio_slam_tpu_torch.pipeline.replay import ReplayBatch
from lio_slam_tpu_torch.utils import se3

# the mission chip_smoke.py drives and the parity fixture records
SMOKE_SCANS = 40
SMOKE_POINTS = 32768
SMOKE_SEED = 0
SMOKE_SPEED = 2.0

# the loop mission: a closed circle of radius speed / yaw_rate = 3.33 m, one
# lap in 2 pi / yaw_rate = 10.47 s = 105 scans, run on until the start has
# been revisited; the loop detector runs every LOOP_EVERY scans.  (At 4 m/s
# on this world the registration slips by more than a metre around scan 50,
# in the JAX package as in the port, and nothing after it is repeatable
# between two float32 implementations; at 2 m/s no scan takes more than 6
# GN iterations.)
LOOP_SCANS = 125
LOOP_SPEED = 2.0
LOOP_YAW_RATE = 0.6
LOOP_EXTENT = 60.0          # half-width of the synthetic world, metres
LOOP_EVERY = 10
LOOP_GPS_SEED = 7
LOOP_GPS_NOISE = 0.05      # metres, each axis

# the archive mission: the loop mission's circle with a 16-keyframe store
ARCHIVE_MAX_KEYFRAMES = 16
ARCHIVE_SCANS = 125
# first-lap scans relocalized against the archive mission's final map
RELOC_SCANS = (5, 75, 95)
# the checkpoint of the resume check, within the 40-scan mission
RESUME_AT = 20

# the bag missions: ROS1 bags written by io/synthetic_bag.py, replayed by
# io/bag_replay.py
BAG_SCANS = 125
HOSTILE_SCANS = 40
BAG_TOPICS = {"gps": "/gps/fix", "raw_gps": "/gpsdata"}
HOSTILE_TOPICS = {"gps": "/gps/fix", "sensor": "robosense"}

# the corner missions: `make_sweep_sequence` through the sweep sensor of
# `bench_config()`'s lidar (16 beams, 1800 azimuth bins), LOAM corners on,
# on the incremental map and on the rebuild-mode map
CORNER_SCANS = 60
REBUILD_SCANS = 40

# the hard-tier replay: the "default" rig's sweep sensor over the outdoor
# world with 2 % garbage returns and 20000 clutter points
# (tools/rig_ate_table.py's "hard" tier), through HostDrivenReplay
HARD_SCANS = 60
HARD_LOOP_EVERY = 10
HARD_KNOBS = dict(outlier_frac=0.02, n_scatter=20000, speed=2.0)
# the deskew mission of tests/test_sweep_sensor.py: a fast oscillating yaw
# seen by a 32-beam sweep, replayed with and without per-point times
DESKEW_SCANS = 20


# chip_smoke.py phase 18, the sharded mission: SHARDED_SCANS scans of the
# smoke mission's sequence, then an injected loop and at most SHARDED_TAIL
# more scans until the full correction has run
SHARDED_SCANS = 40
SHARDED_TAIL = 6
SHARDED_MAP_BUCKETS = 32768     # the mission's grid, split over the ranks


def bag_mission_bag_kwargs() -> dict:
    """`write_synthetic_bag` arguments of the bag mission: the loop
    mission's circle (2 m/s, 0.6 rad/s, a 60 m world) as a 10 Hz lidar of
    32768 points sees it, at epoch stamps, with 100 Hz 9-axis IMU, a
    NavSatFix a scan (covariance 0.25 m^2) and the raw GpswithHeading
    stream.  Replayed through `loop_mission_config()`."""
    return dict(n_scans=BAG_SCANS, n_points=SMOKE_POINTS, seed=SMOKE_SEED,
                epoch=1.7e9, scan_period=0.1, sweep_time=0.1, imu_rate=100.0,
                speed=LOOP_SPEED, yaw_rate=LOOP_YAW_RATE,
                world_extent=LOOP_EXTENT, gps=True, gps_cov=0.25,
                raw_gps_topic=BAG_TOPICS["raw_gps"])


def hostile_bag_kwargs() -> dict:
    """`write_synthetic_bag` arguments of the hostile bag: the options of
    tests/test_hostile_bag.py (bz2 chunks, the Robosense layout with f64
    absolute point stamps, write-order jitter, every 7th IMU message
    duplicated, an IMU dropout, GPS at ten times the scan rate) on a 10 Hz
    lidar of 32768 points, 40 scans of a straight line.  Replayed through
    `hostile_bag_config()`."""
    return dict(n_scans=HOSTILE_SCANS, n_points=SMOKE_POINTS, seed=5,
                epoch=1.7e9, scan_period=0.1, speed=2.0, yaw_rate=0.0,
                gps=True, gps_cov=0.25, gps_rate_hz=100.0, compression="bz2",
                sensor_layout="robosense", shuffle_window=0.005, dup_every=7,
                drop_imu_spans=((1.5, 1.8),))


def bench_config() -> Config:
    """The shapes of `bench.py:bench_config()` (8192 registered points
    against a 32768 x 24 bucket map, K=256 keyframes of 8192 points, window
    32, a 64-sample IMU window at 100 Hz, corr_refresh_every=2), with loop
    closure and GPS off: the per-scan path alone."""
    return Config(
        static=StaticConfig(
            max_raw_points=32768, max_scan_points=8192, max_map_points=65536,
            max_keyframes=256, max_keyframe_points=8192,
            max_loop_queue=8, max_gps_queue=8, window_size=32,
            max_imu_window=64),
        imu=ImuConfig(imu_rate=100.0),
        registration=RegistrationConfig(corr_refresh_every=2),
        loop=LoopClosureConfig(enabled=False))


def sharded_mission_config(n_devices: int) -> Config:
    """`bench_config()` for the sharded mission on `n_devices` ranks: the
    32768-bucket grid split over them (`grid_table_size` counts buckets a
    rank) and the sparse full solver, so the correction runs the
    column-sharded one (K=256 would pick the dense one)."""
    base = bench_config()
    return dataclasses.replace(
        base,
        static=dataclasses.replace(base.static, full_solver="sparse"),
        registration=dataclasses.replace(
            base.registration,
            grid_table_size=SHARDED_MAP_BUCKETS // n_devices))


def loop_mission_config() -> Config:
    """`bench_config()` with loop closure (keyframe archive off) and GPS
    on.  A mission of 12.5 s cannot meet the default 30 s gap between the
    keyframes of a loop pair, so `time_diff` is 10 s: a pair is then a full
    lap apart, a true revisit.  Its pose covariance never comes near the
    default 25 m^2 below which GPS factors are withheld, so
    `pose_cov_threshold` is -1 (the estimate always counts as uncertain) and
    a GPS factor lands every `gps_distance_frequency` = 5 m once the vehicle
    is `min_travel_before_gps` = 5 m from its start.  Every other loop and
    GPS setting is the default."""
    base = bench_config()
    return dataclasses.replace(
        base,
        loop=LoopClosureConfig(enabled=True, archive_enabled=False,
                               time_diff=10.0),
        gps=GpsConfig(use_gps=True, pose_cov_threshold=-1.0))


def archive_mission_config() -> Config:
    """`loop_mission_config()` at the same widths with a device store of 16
    keyframes (256 in `bench_config()`) and the keyframe archive on.  One
    lap is about 32 keyframes, so by the revisit the first lap's keyframes
    have left the store: only the archive can close the loop, and its
    anchors share the unary slots with the live GPS factors."""
    base = loop_mission_config()
    return dataclasses.replace(
        base,
        static=dataclasses.replace(base.static,
                                   max_keyframes=ARCHIVE_MAX_KEYFRAMES),
        loop=dataclasses.replace(base.loop, archive_enabled=True))


def hostile_bag_config() -> Config:
    """`bench_config()` with the GPS settings of tests/test_hostile_bag.py:
    the covariance gate at 2 m^2, no pose-covariance gate, a factor every
    2 m once 3 m from the start."""
    return dataclasses.replace(
        bench_config(),
        gps=GpsConfig(use_gps=True, gps_cov_threshold=2.0,
                      pose_cov_threshold=0.0, min_travel_before_gps=3.0,
                      gps_distance_frequency=2.0))


def corner_mission_config(local_map_mode: str = "incremental") -> Config:
    """`bench_config()` with the LOAM corner term on at the default corner
    capacities (2048 corners a scan and a keyframe, a 16384-point corner
    map), on the incremental map or the rebuild-mode map."""
    base = bench_config()
    return dataclasses.replace(
        base, registration=dataclasses.replace(
            base.registration, use_corner_features=True,
            local_map_mode=local_map_mode))


def hard_replay_config() -> Config:
    """The "default" preset at the full-width shapes of
    tools/rig_ate_table.py (raw 32768, scan 8192, map 65536, K=256, window
    32, a 64-sample IMU window; the preset's IMU runs at 500 Hz)."""
    return dataclasses.replace(get_config("default"), static=StaticConfig(
        max_raw_points=32768, max_scan_points=8192, max_map_points=65536,
        max_keyframes=256, max_keyframe_points=8192, max_loop_queue=8,
        max_gps_queue=8, window_size=32, max_imu_window=64))


def replay_batch(seq: SyntheticSequence, windows, ptimes=None) -> ReplayBatch:
    """A `ReplayBatch` of numpy arrays: the sweep sequence's scans, rings
    and point times (`ptimes` in their place when given) with the IMU
    windows of `synthetic.make_imu_windows`."""
    acc, gyr, dts, rel_t, imask = windows
    return ReplayBatch(
        xyz=seq.scans, ptime=seq.ptimes if ptimes is None else ptimes,
        pmask=seq.scan_masks, ring=seq.rings, acc=acc, gyr=gyr, dts=dts,
        rel_t=rel_t, imask=imask, stamp=seq.stamps)


def batch_sha256(batch: ReplayBatch) -> str:
    """sha256 of every array of a numpy `ReplayBatch`: a run checks with it
    that it replays the inputs its reference replayed."""
    h = hashlib.sha256()
    for a in batch:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def hard_replay_inputs(cfg: Config = None, n_scans: int = HARD_SCANS,
                       n_points: int = SMOKE_POINTS):
    """(sequence, ReplayBatch) of the hard-tier replay: `make_sweep_sequence`
    through `rig_sensor_for(cfg)` (`hard_replay_config()` by default), seed
    0, with `HARD_KNOBS`, and IMU windows covering each sweep
    (`make_imu_windows(sweep_cover=sensor.sweep_time)`)."""
    cfg = cfg or hard_replay_config()
    sensor = synthetic.rig_sensor_for(cfg)
    seq = synthetic.make_sweep_sequence(n_scans=n_scans, n_points=n_points,
                                        seed=SMOKE_SEED, sensor=sensor,
                                        **HARD_KNOBS)
    windows = synthetic.make_imu_windows(
        seq, cfg.static.max_imu_window,
        samples_per_scan=sensor.samples_per_scan, gravity=cfg.imu.gravity,
        sweep_cover=sensor.sweep_time)
    return seq, replay_batch(seq, windows)


def deskew_mission_inputs(n_points: int = 8192):
    """(config, sequence, IMU windows) of the deskew mission of
    tests/test_sweep_sensor.py: 20 sweeps of a 32-beam 60 m scanner at
    0.5 m/s with an oscillating 1.2 rad/s yaw, 10 IMU samples a scan and
    windows that cover each sweep.  Replay it with `replay_batch(seq,
    windows)` and with `ptimes` zeroed (deskew off)."""
    sensor = synthetic.RigSensor(n_scan=32, max_range=60.0,
                                 samples_per_scan=10)
    seq = synthetic.make_sweep_sequence(n_scans=DESKEW_SCANS,
                                        n_points=n_points, seed=SMOKE_SEED,
                                        sensor=sensor, speed=0.5,
                                        yaw_rate=1.2, noise=0.01)
    cfg = Config(
        static=StaticConfig(max_raw_points=n_points,
                            max_scan_points=n_points // 2,
                            max_map_points=4 * n_points, max_keyframes=64,
                            max_keyframe_points=n_points // 2,
                            max_loop_queue=4, max_gps_queue=4, window_size=16,
                            max_imu_window=32),
        registration=RegistrationConfig(degeneracy_eig_thresh=10.0),
        keyframe=KeyframeConfig(dist_threshold=0.2, angle_threshold=0.1))
    windows = synthetic.make_imu_windows(
        seq, cfg.static.max_imu_window,
        samples_per_scan=sensor.samples_per_scan, gravity=cfg.imu.gravity,
        sweep_cover=sensor.sweep_time)
    return cfg, seq, windows


def sweep_inputs(seq: SyntheticSequence, windows):
    """Per-scan `StandardScan`s (rings and point times of the sweep) and
    IMU windows from `synthetic.make_imu_windows` output, as
    `Runner.process_scan` takes them: each window's samples at the scan
    stamp plus their offsets (float64 seconds); scan 0 has none."""
    _, _, _, rel_t, imask = windows
    acc, gyr = windows[0], windows[1]
    scans, imus = [], []
    for i in range(len(seq.stamps)):
        m = seq.scan_masks[i]
        n = int(m.sum())
        scans.append(formats.StandardScan(
            xyz=seq.scans[i][m], intensity=np.zeros(n, np.float32),
            ring=seq.rings[i][m].astype(np.uint16), time=seq.ptimes[i][m],
            stamp=float(seq.stamps[i])))
        w = imask[i]
        imus.append(None if not w.any() else {
            "acc": acc[i][w], "gyr": gyr[i][w],
            "stamps": float(seq.stamps[i]) + rel_t[i][w].astype(np.float64)})
    return scans, imus


def corner_mission_inputs(cfg: Config, n_scans: int = CORNER_SCANS,
                          n_points: int = SMOKE_POINTS):
    """(sequence, scans, IMU windows) of the corner missions: a sweep
    mission of `n_scans` scans of `n_points` through
    `rig_sensor_for(cfg)`, seed 0, with IMU windows that cover each sweep
    (`make_imu_windows(sweep_cover=sweep_time)`)."""
    sensor = synthetic.rig_sensor_for(cfg)
    seq = synthetic.make_sweep_sequence(n_scans=n_scans, n_points=n_points,
                                        seed=SMOKE_SEED, sensor=sensor)
    windows = synthetic.make_imu_windows(
        seq, cfg.static.max_imu_window,
        samples_per_scan=sensor.samples_per_scan, gravity=cfg.imu.gravity,
        sweep_cover=sensor.sweep_time)
    scans, imus = sweep_inputs(seq, windows)
    return seq, scans, imus


def scans_sha256(scans) -> str:
    """sha256 of a mission's `StandardScan`s (points, rings, point times,
    stamps): a run checks with it that it replays the scans its reference
    replayed."""
    h = hashlib.sha256()
    for s in scans:
        for a in (s.xyz, s.ring, s.time, np.float64(s.stamp)):
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def synthetic_inputs(seq: SyntheticSequence, cfg: Config):
    """Per-scan `StandardScan`s and IMU windows, as the JAX runner's
    `_run_synthetic` builds them: constant body rates from the truth
    increment, gravity-only specific force, `imu_rate * span` samples
    ending at the scan stamp."""
    scans, imus = [], []
    for i in range(len(seq.stamps)):
        m = seq.scan_masks[i]
        n = int(m.sum())
        scans.append(formats.StandardScan(
            xyz=seq.scans[i][m], intensity=np.zeros(n, np.float32),
            ring=np.zeros(n, np.uint16), time=np.zeros(n, np.float32),
            stamp=float(seq.stamps[i])))
        if i == 0:
            imus.append(None)
            continue
        inc = se3.pose6_between(torch.from_numpy(seq.poses[i - 1]),
                                torch.from_numpy(seq.poses[i])).numpy()
        span = float(seq.stamps[i] - seq.stamps[i - 1])
        T = max(int(round(cfg.imu.imu_rate * span)), 2)
        dtau = span / T
        imus.append({
            "acc": np.tile([0, 0, cfg.imu.gravity], (T, 1)).astype(np.float32),
            "gyr": np.tile(inc[:3] / (T * dtau), (T, 1)).astype(np.float32),
            "stamps": seq.stamps[i - 1] + np.arange(1, T + 1) * dtau})
    return scans, imus


def loop_mission_inputs(cfg: Config, n_scans: int = LOOP_SCANS,
                        n_points: int = SMOKE_POINTS):
    """(sequence, scans, IMU windows, per-scan GPS fix lists) of the loop
    mission."""
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=n_points,
                                  seed=SMOKE_SEED, speed=LOOP_SPEED,
                                  yaw_rate=LOOP_YAW_RATE, extent=LOOP_EXTENT)
    scans, imus = synthetic_inputs(seq, cfg)
    fixes = synthetic.gps_fixes_from_truth(
        relative_truth(seq)[:, 3:].astype(np.float64), seq.stamps,
        seed=LOOP_GPS_SEED, noise=LOOP_GPS_NOISE)
    return seq, scans, imus, fixes


def relative_truth(seq: SyntheticSequence) -> np.ndarray:
    """Truth poses in the odometry frame anchored at the first pose."""
    p0 = torch.from_numpy(seq.poses[0])
    return np.stack([se3.pose6_between(p0, torch.from_numpy(p)).numpy()
                     for p in seq.poses])
