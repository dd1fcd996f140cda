"""Inputs and configuration of the synthetic missions the port is run and
checked on: the runner CLI, `chip_smoke.py`, the parity tests and the
fixture script all build their scans and IMU windows here, so every side
of a comparison sees the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from lio_slam_tpu_torch.config import (Config, ImuConfig, LoopClosureConfig,
                                       RegistrationConfig, StaticConfig)
from lio_slam_tpu_torch.io import formats
from lio_slam_tpu_torch.io.synthetic import SyntheticSequence
from lio_slam_tpu_torch.utils import se3

# the mission chip_smoke.py drives and the parity fixture records
SMOKE_SCANS = 40
SMOKE_POINTS = 32768
SMOKE_SEED = 0
SMOKE_SPEED = 2.0


def bench_config() -> Config:
    """The shapes of `bench.py:bench_config()` (8192 registered points
    against a 32768 x 24 bucket map, K=256 keyframes of 8192 points, window
    32, a 64-sample IMU window at 100 Hz, corr_refresh_every=2), with loop
    closure off because the port does not run it yet."""
    return Config(
        static=StaticConfig(
            max_raw_points=32768, max_scan_points=8192, max_map_points=65536,
            max_keyframes=256, max_keyframe_points=8192,
            max_loop_queue=8, max_gps_queue=8, window_size=32,
            max_imu_window=64),
        imu=ImuConfig(imu_rate=100.0),
        registration=RegistrationConfig(corr_refresh_every=2),
        loop=LoopClosureConfig(enabled=False))


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


def relative_truth(seq: SyntheticSequence) -> np.ndarray:
    """Truth poses in the odometry frame anchored at the first pose."""
    p0 = torch.from_numpy(seq.poses[0])
    return np.stack([se3.pose6_between(p0, torch.from_numpy(p)).numpy()
                     for p in seq.poses])
