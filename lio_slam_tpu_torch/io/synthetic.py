"""Synthetic LiDAR/IMU sequence generator (port of the parts of
`lio_slam_tpu/io/synthetic.py` the port's runner and tests use): the clean
instantaneous-scan mission, and the spinning-scanner (sweep) mission with
rings, per-point times and its IMU windows.

numpy with the same `RandomState` call order as the JAX package, so one
seed gives the same world, trajectory and scans; the rotations go through
the port's own se3 on float32 CPU tensors (the JAX copy's jnp float32).
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
    # spinning-scanner sequences (make_sweep_sequence) also carry:
    ptimes: np.ndarray = None  # (T, N) per-point seconds since sweep start
    rings: np.ndarray = None   # (T, N) int32 beam index


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


class RigSensor(NamedTuple):
    """Spinning-scanner geometry of the sweep observation model: the
    per-rig knobs that differ across the reference's configs (N_SCAN, FOV,
    range, IMU rate)."""

    n_scan: int = 32          # beams (N_SCAN)
    fov_up: float = 15.0      # deg
    fov_down: float = -25.0   # deg
    max_range: float = 60.0   # m
    sweep_time: float = 0.1   # s per revolution (10 Hz scanner)
    samples_per_scan: int = 10  # IMU samples per scan interval (rate x 0.1)


def rig_sensor_for(cfg) -> RigSensor:
    """The sweep sensor of a Config: beam count, range and IMU rate from the
    rig's parameters; the vertical FOV wide enough to see the synthetic
    world at any beam count."""
    lid = cfg.lidar
    return RigSensor(
        n_scan=int(lid.n_scan),
        max_range=float(min(lid.lidar_max_range, 80.0)),
        samples_per_scan=max(int(round(cfg.imu.imu_rate * 0.1)), 2))


def _rotation(pose6: np.ndarray) -> np.ndarray:
    """The float32 rotation matrix of a pose6."""
    return se3.pose6_to_Rt(torch.as_tensor(pose6, dtype=torch.float32))[0].numpy()


def _pose_interp(poses: np.ndarray, stamps: np.ndarray, t: float) -> np.ndarray:
    """Componentwise linear interpolation along the trajectory (its yaw is
    continuous, so no wrap handling)."""
    i = int(np.clip(np.searchsorted(stamps, t) - 1, 0, len(stamps) - 2))
    a = (t - stamps[i]) / max(stamps[i + 1] - stamps[i], 1e-9)
    a = min(max(a, 0.0), 1.0)
    return poses[i] * (1.0 - a) + poses[i + 1] * a


def make_sweep_trajectory(n_scans: int, dt: float = 0.1, speed: float = 2.0,
                          yaw_rate: float = 0.15, ramp: float = 0.5,
                          osc: float = 0.5, osc_freq: float = 2.0):
    """Trajectory of a sweep mission: it starts at rest (the first sweep is
    undistorted) and its yaw rate oscillates, so each sweep is distorted
    differently."""
    ts = np.arange(n_scans, dtype=np.float32) * dt
    s = np.clip(ts / max(ramp, 1e-6), 0.0, 1.0)
    w = yaw_rate * s * (1.0 + osc * np.sin(osc_freq * ts))
    v = speed * s
    yaw = np.cumsum(w * dt)
    x = np.cumsum(np.cos(yaw) * v * dt)
    y = np.cumsum(np.sin(yaw) * v * dt)
    z = 0.5 + 0.1 * np.sin(ts * 0.5) * s
    roll = 0.02 * np.sin(ts * 0.7) * s
    pitch = 0.02 * np.cos(ts * 0.9) * s
    return np.stack([roll, pitch, yaw, x, y, z], 1).astype(np.float32), ts


def observe_sweep(world: np.ndarray, poses: np.ndarray, stamps: np.ndarray,
                  i: int, n_points: int, sensor: RigSensor,
                  noise: float = 0.01,
                  rng: np.random.RandomState | None = None,
                  time_bins: int = 32):
    """Spinning-scanner observation of scan i: each azimuth is seen at the
    pose the platform had at that instant of the sweep (intra-scan motion
    distortion, imageProjection.cpp:502-575), through `sensor.n_scan`
    discrete elevation beams.  Point time is relative to the sweep start
    (the scan stamp).  Returns (xyz, ptime, ring, mask), each
    (n_points, ...)."""
    rng = rng or np.random.RandomState(0)
    t0 = float(stamps[i])
    p0 = _pose_interp(poses, stamps, t0)
    R0 = _rotation(p0)
    tr0 = p0[3:6]
    b0 = (world - tr0[None, :]) @ R0                  # R0^T (w - t), rows
    d = np.linalg.norm(b0, axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        elev = np.degrees(np.arcsin(np.clip(b0[:, 2] / np.maximum(d, 1e-6),
                                            -1.0, 1.0)))
    spacing = (sensor.fov_up - sensor.fov_down) / max(sensor.n_scan - 1, 1)
    ring_f = (elev - sensor.fov_down) / spacing
    ring = np.round(ring_f).astype(np.int32)
    # discrete beams: points within the acceptance half-width of a beam
    beam_tol = min(0.35, spacing * 0.5)
    on_beam = np.abs(elev - (sensor.fov_down + ring * spacing)) < beam_tol
    vis = ((d < sensor.max_range) & (d > 0.8)
           & (ring >= 0) & (ring < sensor.n_scan) & on_beam)
    sel_all = np.where(vis)[0]
    take = min(n_points, len(sel_all))
    if take == 0:
        z = np.zeros((n_points, 3), np.float32)
        return (z, np.zeros(n_points, np.float32),
                np.zeros(n_points, np.int32), np.zeros(n_points, bool))
    logw = -2.0 * np.log(d[sel_all])                  # 1/d^2, like `observe`
    keys = logw + rng.gumbel(size=len(sel_all))
    sel = sel_all[np.argpartition(-keys, take - 1)[:take]]
    az = np.mod(np.arctan2(b0[sel, 1], b0[sel, 0]), 2.0 * np.pi)
    ptime = (az / (2.0 * np.pi) * sensor.sweep_time).astype(np.float32)
    # each azimuth at the pose the scanner had then (binned)
    out = np.zeros((take, 3), np.float32)
    edges = np.linspace(0.0, sensor.sweep_time, time_bins + 1)
    bin_of = np.clip(np.digitize(ptime, edges) - 1, 0, time_bins - 1)
    for b in range(time_bins):
        m = bin_of == b
        if not m.any():
            continue
        tb = t0 + 0.5 * (edges[b] + edges[b + 1])
        pb = _pose_interp(poses, stamps, tb)
        Rb = _rotation(pb)
        out[m] = ((world[sel[m]] - pb[3:6][None, :]) @ Rb).astype(np.float32)
    out += rng.randn(take, 3).astype(np.float32) * noise
    xyz = np.zeros((n_points, 3), np.float32)
    xyz[:take] = out
    pt = np.zeros(n_points, np.float32)
    pt[:take] = ptime
    rg = np.zeros(n_points, np.int32)
    rg[:take] = ring[sel]
    mask = np.arange(n_points) < take
    return xyz, pt, rg, mask


def make_sweep_sequence(n_scans: int = 40, n_points: int = 8192,
                        seed: int = 0, sensor: RigSensor = RigSensor(),
                        speed: float = 2.0, yaw_rate: float = 0.15,
                        noise: float = 0.01, rpy_noise: float = 0.002,
                        extent: float = 60.0,
                        outlier_frac: float = 0.0,
                        n_scatter: int = 0,
                        world: np.ndarray = None) -> SyntheticSequence:
    """Spinning-scanner mission: every scan observed through
    `observe_sweep`, so it carries intra-scan motion distortion, per-point
    times and beam indices; `poses` / `stamps` are at sweep start.
    `outlier_frac` replaces that share of each scan by uniform garbage,
    `n_scatter` adds random clutter to the world, `world` replaces the
    default outdoor world."""
    rs = np.random.RandomState(seed + 1)
    if world is None:
        world = make_world(seed, extent=extent)
    if n_scatter:
        u = lambda n, lo, hi: rs.uniform(lo, hi, n).astype(np.float32)
        scatter = np.stack([u(n_scatter, -extent, extent),
                            u(n_scatter, -extent, extent),
                            u(n_scatter, 0.2, 3.0)], 1)
        world = np.concatenate([world, scatter])
    # one extra trajectory sample: the last sweep interpolates past its stamp
    poses_ext, stamps_ext = make_sweep_trajectory(n_scans + 1, speed=speed,
                                                  yaw_rate=yaw_rate)
    scans = np.zeros((n_scans, n_points, 3), np.float32)
    ptimes = np.zeros((n_scans, n_points), np.float32)
    rings = np.zeros((n_scans, n_points), np.int32)
    masks = np.zeros((n_scans, n_points), bool)
    for i in range(n_scans):
        scans[i], ptimes[i], rings[i], masks[i] = observe_sweep(
            world, poses_ext, stamps_ext, i, n_points, sensor,
            noise=noise, rng=rs)
        n_valid = int(masks[i].sum())
        if outlier_frac > 0.0 and n_valid:
            n_out = int(n_valid * outlier_frac)
            if n_out:
                idx = rs.choice(n_valid, n_out, replace=False)
                scans[i, idx] = np.stack([
                    rs.uniform(-40, 40, n_out), rs.uniform(-40, 40, n_out),
                    rs.uniform(-2, 10, n_out)], 1).astype(np.float32)
    poses = poses_ext[:n_scans]
    imu_rpy = poses[:, :3] + rs.randn(n_scans, 3).astype(np.float32) * rpy_noise
    return SyntheticSequence(world=world, poses=poses,
                             stamps=stamps_ext[:n_scans], scans=scans,
                             scan_masks=masks, imu_rpy=imu_rpy,
                             ptimes=ptimes, rings=rings)


def make_imu_windows(seq: SyntheticSequence, window: int,
                     samples_per_scan: int = 10, gravity: float = 9.80511,
                     gyr_noise: float = 0.0, acc_noise: float = 0.0,
                     seed: int = 0, sweep_cover: float = 0.0):
    """Emulated IMU windows, one a scan, over (t_{i-1}, t_i]: body rates
    from the rotation increment Log(R_{i-1}^T R_i)/dt, specific force
    R_i^T (dv_world/dt + g e_z) with the velocity finite-differenced from
    the trajectory.  `sweep_cover > 0` appends samples over
    (t_i, t_i + sweep_cover] for the deskew rotation table (coverage past
    the sweep end, imageProjection.cpp:359-376); the front-end's correction
    (rel_t <= 0) leaves them out.

    Returns (acc (N,W,3), gyr (N,W,3), dts (N,W), rel_t (N,W),
    imask (N,W)) padded to `window`, in `Runner._prep_imu_window`'s layout
    (rel_t relative to the scan stamp)."""
    rs = np.random.RandomState(seed + 7)
    n = len(seq.stamps)
    W = window
    T = samples_per_scan
    acc = np.zeros((n, W, 3), np.float32)
    gyr = np.zeros((n, W, 3), np.float32)
    dts = np.zeros((n, W), np.float32)
    rel_t = np.zeros((n, W), np.float32)
    imask = np.zeros((n, W), bool)

    # world velocities and accelerations at scan times (central differences)
    p = seq.poses[:, 3:].astype(np.float64)
    st = seq.stamps.astype(np.float64)
    v = np.gradient(p, st, axis=0)
    a_w = np.gradient(v, st, axis=0)

    def body_rates(i, j):
        """(w_body, a_body) over the interval poses[i] -> poses[j]."""
        dt_scan = float(st[j] - st[i])
        Rm_prev = _rotation(seq.poses[i])
        Rm = _rotation(seq.poses[j])
        w_body = se3.so3_log(torch.from_numpy(Rm_prev.T @ Rm)).numpy() / dt_scan
        a_body = Rm.T @ (a_w[j] + np.array([0.0, 0.0, gravity]))
        return w_body, a_body

    for i in range(1, n):
        dt_scan = float(st[i] - st[i - 1])
        w_body, a_body = body_rates(i - 1, i)
        k = min(T, W)
        gyr[i, :k] = w_body[None, :] + rs.randn(k, 3) * gyr_noise
        acc[i, :k] = a_body[None, :] + rs.randn(k, 3) * acc_noise
        dts[i, :k] = dt_scan / T
        # samples end exactly at the scan stamp (bracketing the correction)
        rel_t[i, :k] = (np.linspace(st[i - 1], st[i], T + 1)[1:k + 1]
                        - st[i]).astype(np.float32)
        imask[i, :k] = True
        if sweep_cover > 0.0:
            # the next interval's rates stand for the sweep's motion
            j = min(i + 1, n - 1)
            w_nxt, a_nxt = body_rates(i, j) if j > i else (w_body, a_body)
            ks = min(max(int(np.ceil(T * sweep_cover / dt_scan)), 2), W - k)
            if ks > 0:
                gyr[i, k:k + ks] = w_nxt[None, :] + rs.randn(ks, 3) * gyr_noise
                acc[i, k:k + ks] = a_nxt[None, :] + rs.randn(ks, 3) * acc_noise
                dts[i, k:k + ks] = sweep_cover / ks
                rel_t[i, k:k + ks] = np.linspace(
                    0.0, sweep_cover, ks + 1)[1:].astype(np.float32)
                imask[i, k:k + ks] = True
    return (acc, gyr, dts, rel_t, imask)


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
