"""Synthetic LiDAR/IMU sequence generator (port of the parts of
`lio_slam_tpu/io/synthetic.py` the port's runner and tests use).

numpy with the same `RandomState` call order as the JAX package, so one
seed gives the same world, trajectory and scans; the body-frame transforms
go through the port's own se3 on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lio_slam_tpu_torch.utils import enu
from lio_slam_tpu_torch.utils import se3


class SyntheticSequence(NamedTuple):
    world: np.ndarray        # (W, 3) world points
    poses: np.ndarray        # (T, 6) ground-truth pose6 per scan
    stamps: np.ndarray       # (T,)
    scans: np.ndarray        # (T, N, 3) body-frame observations
    scan_masks: np.ndarray   # (T, N)
    imu_rpy: np.ndarray      # (T, 3) noisy attitude per scan


def make_world(seed: int = 0, extent: float = 45.0, n_per_surface: int = 60000):
    """Ground plane, boundary walls and box 'buildings'."""
    rs = np.random.RandomState(seed)
    u = lambda n, lo, hi: rs.uniform(lo, hi, n).astype(np.float32)
    e = extent
    surfaces = [
        np.stack([u(n_per_surface, -e, e), u(n_per_surface, -e, e),
                  np.zeros(n_per_surface, np.float32)], 1),
        np.stack([np.full(n_per_surface // 2, e, np.float32),
                  u(n_per_surface // 2, -e, e), u(n_per_surface // 2, 0, 8)], 1),
        np.stack([u(n_per_surface // 2, -e, e),
                  np.full(n_per_surface // 2, -e, np.float32),
                  u(n_per_surface // 2, 0, 8)], 1),
    ]
    for bx, by, w, h in [(-20, -20, 8, 6), (15, 10, 10, 5), (-10, 25, 6, 7),
                         (25, -25, 7, 4), (0, -35, 9, 5)]:
        n = n_per_surface // 8
        for (x0, y0, x1, y1) in [(bx, by, bx + w, by), (bx, by, bx, by + w),
                                 (bx + w, by, bx + w, by + w),
                                 (bx, by + w, bx + w, by + w)]:
            t = u(n, 0, 1)
            surfaces.append(np.stack([x0 + (x1 - x0) * t, y0 + (y1 - y0) * t,
                                      u(n, 0, h)], 1))
    world = np.concatenate(surfaces).astype(np.float32)
    world += rs.randn(*world.shape).astype(np.float32) * 0.01
    return world


def make_trajectory(n_scans: int, dt: float = 0.1, speed: float = 2.0,
                    yaw_rate: float = 0.15):
    """Smooth arc trajectory with gentle roll/pitch oscillation."""
    ts = np.arange(n_scans, dtype=np.float32) * dt
    yaw = yaw_rate * ts
    x = np.cumsum(np.cos(yaw) * speed * dt)
    y = np.cumsum(np.sin(yaw) * speed * dt)
    z = 0.5 + 0.1 * np.sin(ts * 0.5)
    roll = 0.02 * np.sin(ts * 0.7)
    pitch = 0.02 * np.cos(ts * 0.9)
    return np.stack([roll, pitch, yaw, x, y, z], 1).astype(np.float32), ts


def observe(world: np.ndarray, pose6: np.ndarray, n_points: int,
            max_range: float = 60.0, noise: float = 0.01,
            rng: np.random.RandomState | None = None):
    """Sample a body-frame scan of the world from a pose (1/d^2 weighted)."""
    rng = rng or np.random.RandomState(0)
    R, t = se3.pose6_to_Rt(torch.as_tensor(pose6))
    Ri, ti = se3.inverse(R, t)
    d = np.linalg.norm(world - t.numpy()[None, :], axis=1)
    visible = np.where((d < max_range) & (d > 0.5))[0]
    take = min(n_points, len(visible))
    logw = -2.0 * np.log(d[visible])
    keys = logw + rng.gumbel(size=len(visible))
    sel = visible[np.argpartition(-keys, take - 1)[:take]]
    body = se3.transform_points(Ri, ti, torch.from_numpy(world[sel])).numpy()
    body = body + rng.randn(*body.shape).astype(np.float32) * noise
    out = np.zeros((n_points, 3), np.float32)
    out[:take] = body
    mask = np.zeros(n_points, bool)
    mask[:take] = True
    return out, mask


def make_sequence(n_scans: int = 40, n_points: int = 8192, seed: int = 0,
                  speed: float = 2.0, yaw_rate: float = 0.15,
                  noise: float = 0.01, rpy_noise: float = 0.002,
                  extent: float = 60.0) -> SyntheticSequence:
    """The clean synthetic mission (the JAX generator's default knobs; its
    hard-world options are not ported)."""
    rs = np.random.RandomState(seed + 1)
    world = make_world(seed, extent=extent)
    poses, stamps = make_trajectory(n_scans, speed=speed, yaw_rate=yaw_rate)
    scans = np.zeros((n_scans, n_points, 3), np.float32)
    masks = np.zeros((n_scans, n_points), bool)
    for i in range(n_scans):
        scans[i], masks[i] = observe(world, poses[i], n_points, noise=noise,
                                     rng=rs)
    imu_rpy = poses[:, :3] + rs.randn(n_scans, 3).astype(np.float32) * rpy_noise
    return SyntheticSequence(world=world, poses=poses, stamps=stamps,
                             scans=scans, scan_masks=masks, imu_rpy=imu_rpy)


def gps_fixes_from_truth(positions: np.ndarray, stamps: np.ndarray,
                         seed: int = 0, noise: float = 0.05,
                         datum=(48.0, 11.0, 500.0), n_datum: int = 5):
    """Per-scan lists of GPS fixes (stamp, lat, lon, alt, status, covariance)
    for `Runner.process_scan(gps_fixes=...)`: the truth positions (T, 3), in
    metres in the frame anchored at the first pose, through
    `LocalCartesian.reverse` at `datum`, with seeded Gaussian noise.  Scan 0
    carries `n_datum` fixes of the start position (a receiver that had a
    fix before the vehicle moved), so the intake's averaged datum is the
    trajectory's origin; every later scan carries one fix."""
    rs = np.random.RandomState(seed)
    lc = enu.LocalCartesian(*datum)

    def fix(stamp, pos):
        lat, lon, alt = lc.reverse(pos + rs.randn(3) * noise)
        return (float(stamp), float(lat), float(lon), float(alt), 0, None)

    dt = float(stamps[1] - stamps[0]) if len(stamps) > 1 else 0.1
    out = [[fix(stamps[0] - (n_datum - 1 - k) * dt, positions[0])
            for k in range(n_datum)]]
    for i in range(1, len(stamps)):
        out.append([fix(stamps[i], positions[i])])
    return out


def ate_rmse(est: np.ndarray, truth: np.ndarray) -> float:
    """Translation RMSE, no alignment (both anchored at the first pose)."""
    d = est[:, 3:] - truth[:, 3:]
    return float(np.sqrt((d * d).sum(1).mean()))
