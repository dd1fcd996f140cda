"""Synthetic ROS1 bag generator — closes the real-data validation loop.

The reference's entire validation regime is bag replay
(`src/liorf/README.md:137-158, 220-283`: `rosbag play ... roslaunch liorf`).
No reference bag ships in this environment, so this module writes REAL
`.bag` files with the properties that break naive pipelines:

- epoch-magnitude timestamps (~1.7e9 s; float32 ulp there is 128 s),
- a per-point relative `time` channel + in-sweep rotational skew that the
  deskew stage must undo (imageProjection.cpp:502-575),
- 9-axis IMU messages with orientation quaternions (imuDeskewInfo :381-385),
- NavSatFix GPS with a position covariance the factor gating consumes
  (addGPSFactor :1984-1989), with an optional jam window for the FSM.

The trajectory/world come from `io.synthetic`; encoders from `io.rosbag`.

The port's copy of `lio_slam_tpu/io/synthetic_bag.py`: a host-side data
generator.  The rotations go through the port's `utils/se3` on CPU tensors
in float32, where the JAX writer uses `jax.numpy` (float32 by default), so
a bag written by either package carries the same messages (to float32
rounding) for the same arguments.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lio_slam_tpu_torch.io import rosbag as rb
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.utils import enu as enu_mod
from lio_slam_tpu_torch.utils import se3


@dataclass
class SyntheticBagTruth:
    """Ground truth paired with a written bag (for ATE scoring)."""

    poses: np.ndarray       # (T, 6) world-frame pose6 per scan
    stamps: np.ndarray      # (T,) epoch seconds
    datum: tuple            # (lat, lon, alt) GPS datum (if gps enabled)


def _f32(a) -> torch.Tensor:
    """A float32 CPU tensor of `a` (the JAX writer's default dtype)."""
    return torch.from_numpy(np.asarray(a, np.float32))


def write_synthetic_bag(
    path: str,
    n_scans: int = 36,
    n_points: int = 4096,
    seed: int = 0,
    epoch: float = 1.7e9,
    scan_period: float = 1.0,
    sweep_time: float = 0.1,
    imu_rate: float = 100.0,
    speed: float = 2.0,
    yaw_rate: float = 0.0,
    gps: bool = False,
    gps_cov: float = 0.25,
    gps_jam: tuple | None = None,     # (start_s, end_s) window with no fixes
    gps_bad_cov_every: int = 0,       # every k-th fix gets covariance 100
    datum: tuple = (31.0, 121.0, 10.0),
    lidar_topic: str = "/velodyne_points",
    imu_topic: str = "/imu/data",
    gps_topic: str = "/gps/fix",
    raw_gps_topic: str | None = None,  # "gpsdata" raw vehicle stream — keeps
                                       # arriving through corrected-GPS jams
                                       # (drives the positioning-mode FSM)
    world_extent: float = 60.0,
    noise: float = 0.01,
    # --- hostile-stream options (round-3: adversarially mimic messy vehicle
    # logs, the intake conditions the reference validates fatally in
    # imageProjection.cpp:294-334 and README's field logs) ---
    compression: str = "none",        # "bz2": rosbag-compress chunking
    sensor_layout: str = "velodyne",  # "robosense": f64 absolute per-point
                                      # timestamps (RsPointXYZIRT)
    shuffle_window: float = 0.0,      # seconds of write-order jitter
                                      # (out-of-order arrival; header stamps
                                      # stay truthful)
    dup_every: int = 0,               # duplicate every k-th IMU message
    drop_imu_spans: tuple = (),       # ((start_s, end_s), ...) mission-rel
                                      # windows with NO IMU samples
    gps_rate_hz: float = 0.0,         # >0: continuous GPS stream at this
                                      # rate (bursts above scan rate)
) -> SyntheticBagTruth:
    """Write a time-ordered synthetic mission bag; returns the ground truth.

    With yaw_rate = 2*pi / (n_scans*scan_period) the trajectory is a closed
    circle — revisiting the start after the loop-closure time gate, so replay
    exercises the RS/SC loop path end-to-end.
    """
    rs = np.random.RandomState(seed + 17)
    world = synthetic.make_world(seed, extent=world_extent)
    poses, rel_ts = synthetic.make_trajectory(n_scans, dt=scan_period,
                                              speed=speed, yaw_rate=yaw_rate)
    stamps = epoch + rel_ts.astype(np.float64)

    # body angular rate per inter-scan interval (constant-rate model):
    # R_{i-1}^T R_i = exp(w * dt)
    Rm = np.stack([se3.pose6_to_Rt(_f32(p))[0].numpy() for p in poses])
    omegas = np.zeros((n_scans, 3), np.float32)     # rate over [i-1, i]
    for i in range(1, n_scans):
        rel = Rm[i - 1].T @ Rm[i]
        omegas[i] = se3.so3_log(_f32(rel)).numpy() / scan_period
    # world-frame velocity / acceleration for the accelerometer model
    vel = np.gradient(poses[:, 3:6], scan_period, axis=0)
    acc_w = np.gradient(vel, scan_period, axis=0)
    g = 9.80511

    geo = enu_mod.LocalCartesian(*datum)
    writer = rb.BagWriter(path, compression=compression)
    events = []        # (stamp, order_key, topic, type, raw)
    n_imu_written = 0

    for i in range(n_scans):
        # --- lidar scan with rotational in-sweep skew ---
        body, mask = synthetic.observe(world, poses[i], n_points,
                                       noise=noise, rng=rs)
        nv = int(mask.sum())
        t_pt = np.sort(rs.uniform(0.0, sweep_time, nv)).astype(np.float32)
        w_next = omegas[min(i + 1, n_scans - 1)]    # rate during this sweep
        # distort: p_obs(t) = exp(w t)^T p_true  (deskew undoes exactly this
        # from the integrated gyro table)
        Rrel = se3.so3_exp(_f32(
            w_next[None, :] * t_pt[:, None])).numpy()    # (nv, 3, 3)
        body[:nv] = np.einsum("kij,ki->kj", Rrel, body[:nv])   # R^T p
        times = np.zeros(n_points, np.float32)
        times[:nv] = t_pt
        ring = (np.arange(n_points) % 16).astype(np.uint16)
        if sensor_layout == "robosense":
            # RsPointXYZIRT: absolute f64 epoch timestamps per point
            ts_abs = stamps[i] + t_pt.astype(np.float64)
            raw = rb.encode_pointcloud2_robosense(
                body[:nv], np.zeros(nv, np.float32), ring[:nv], ts_abs,
                stamps[i])
        else:
            raw = rb.encode_pointcloud2(body[:nv], np.zeros(nv, np.float32),
                                        ring[:nv], times[:nv], stamps[i])
        events.append((stamps[i], 1, lidar_topic,
                       "sensor_msgs/PointCloud2", raw))

        # --- IMU stream over (stamp[i], stamp[i+1]] ---
        if i + 1 < n_scans:
            n_samp = max(int(round(imu_rate * scan_period)), 2)
            dts = scan_period / n_samp
            w = omegas[i + 1]
            steps = np.arange(1, n_samp + 1)
            R_rel = se3.so3_exp(_f32(
                w[None, :] * (steps * dts)[:, None])).numpy()   # (S, 3, 3)
            R_full = np.einsum("ij,sjk->sik", Rm[i], R_rel)
            q_all = se3.matrix_to_quat(_f32(R_full)).numpy().astype(
                np.float64)                                 # (S, 4) wxyz
            for s in steps:
                ts = stamps[i] + s * dts
                alpha = s / n_samp
                a_w = (1 - alpha) * acc_w[i] + alpha * acc_w[min(i + 1,
                                                                 n_scans - 1)]
                acc_body = R_full[s - 1].T @ (a_w + np.array([0.0, 0.0, g]))
                qw = q_all[s - 1]
                quat = np.array([qw[1], qw[2], qw[3], qw[0]])   # -> xyzw
                trel_s = ts - epoch
                if any(a <= trel_s < b for (a, b) in drop_imu_spans):
                    continue                # dropped span (mid-sweep gap)
                raw = rb.encode_imu(ts, quat, w.astype(np.float64),
                                    acc_body.astype(np.float64))
                events.append((ts, 0, imu_topic, "sensor_msgs/Imu", raw))
                n_imu_written += 1
                if dup_every and n_imu_written % dup_every == 0:
                    # duplicate message (same stamp + payload) — real logs
                    # contain them; the intake must not double-integrate
                    # the sample nor crash
                    events.append((ts, 0, imu_topic, "sensor_msgs/Imu", raw))

        # --- GPS fix at scan time ---
        if gps and gps_rate_hz <= 0:
            trel = float(rel_ts[i])
            jammed = gps_jam is not None and gps_jam[0] <= trel < gps_jam[1]
            if not jammed:
                enu = poses[i, 3:6].astype(np.float64) + \
                    rs.randn(3) * np.sqrt(gps_cov) * 0.2
                lat, lon, alt = geo.reverse(enu)
                cov = np.zeros(9)
                bad = gps_bad_cov_every and (i % gps_bad_cov_every == 0) and i > 0
                cov[0] = cov[4] = cov[8] = 100.0 if bad else gps_cov
                raw = rb.encode_navsatfix(stamps[i] + 0.01, float(lat),
                                          float(lon), float(alt), cov=cov)
                events.append((stamps[i] + 0.01, 2, gps_topic,
                               "sensor_msgs/NavSatFix", raw))
        if raw_gps_topic is not None:
            # the raw vehicle record (GpswithHeading) is unaffected by the
            # corrected-stream jam window
            enu_r = poses[i, 3:6].astype(np.float64) + rs.randn(3) * 0.5
            lat_r, lon_r, alt_r = geo.reverse(enu_r)
            heading = float(enu_mod.heading_from_yaw(float(poses[i, 2])))
            raw = rb.encode_gps_with_heading(
                stamps[i] + 0.02, float(lat_r), float(lon_r), float(alt_r),
                heading, 0.0, 0.0, mode=0)
            events.append((stamps[i] + 0.02, 3, raw_gps_topic,
                           "sensor_driver_msgs/GpswithHeading", raw))

    # --- continuous GPS stream above scan rate (bursts) ---
    if gps and gps_rate_hz > 0:
        n_fix = int((rel_ts[-1] - rel_ts[0]) * gps_rate_hz) + 1
        fix_rel = rel_ts[0] + np.arange(n_fix) / gps_rate_hz
        k = 0
        for trel in fix_rel:
            jammed = gps_jam is not None and gps_jam[0] <= trel < gps_jam[1]
            if jammed:
                continue
            # linear pose interpolation between bracketing scans
            j = int(np.clip(np.searchsorted(rel_ts, trel) - 1, 0,
                            n_scans - 2))
            a = (trel - rel_ts[j]) / max(rel_ts[j + 1] - rel_ts[j], 1e-9)
            pos = (1 - a) * poses[j, 3:6] + a * poses[j + 1, 3:6]
            enu = pos.astype(np.float64) + rs.randn(3) * np.sqrt(gps_cov) * 0.2
            lat, lon, alt = geo.reverse(enu)
            cov = np.zeros(9)
            k += 1
            bad = gps_bad_cov_every and (k % gps_bad_cov_every == 0)
            cov[0] = cov[4] = cov[8] = 100.0 if bad else gps_cov
            ts = epoch + float(trel)
            raw = rb.encode_navsatfix(ts, float(lat), float(lon), float(alt),
                                      cov=cov)
            events.append((ts, 2, gps_topic, "sensor_msgs/NavSatFix", raw))

    if shuffle_window > 0:
        # out-of-order ARRIVAL: jitter only the write-order key; header
        # stamps stay truthful (how a loaded DDS/TCPROS graph actually
        # misorders messages)
        events.sort(key=lambda e: (
            e[0] + rs.uniform(-shuffle_window, shuffle_window), e[1]))
    else:
        events.sort(key=lambda e: (e[0], e[1]))
    for stamp, _, topic, mtype, raw in events:
        writer.write(topic, mtype, raw, stamp)
    writer.close()
    return SyntheticBagTruth(poses=poses, stamps=stamps, datum=datum)
