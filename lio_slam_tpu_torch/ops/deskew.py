"""Scan deskew: IMU rotation-table integration + per-point motion
compensation (port of `lio_slam_tpu/ops/deskew.py`,
imageProjection.cpp:339-575).

The table composes per-sample rotations on SO(3): R_t = R_{t-1} exp(w_t d_t).
The increments are computed batched, the cumulative products by the
log-depth `smallmat.associative_scan` (the JAX `lax.scan` multiplies
them in sequence: the same products, reassociated), and the rotation
vectors batched at the end.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lio_slam_tpu_torch.utils import se3, smallmat


class RotationTable(NamedTuple):
    """Cumulative rotation since the window start, sampled at IMU times."""

    times: torch.Tensor     # (T,) seconds relative to scan start
    rotvec: torch.Tensor    # (T, 3) rotation vector of R(window_start -> t)
    mask: torch.Tensor      # (T,) bool valid samples


def build_rotation_table(gyr: torch.Tensor, times: torch.Tensor,
                         mask: torch.Tensor) -> RotationTable:
    """Integrate gyro samples (T, 3) at `times` (T,) into a cumulative
    rotation table; invalid samples integrate as zero rotation."""
    dt = torch.diff(times, prepend=times[:1])
    dt = torch.where(mask, torch.clamp(dt, min=0.0), torch.zeros_like(dt))
    steps = se3.so3_exp(gyr * dt[:, None])                       # (T, 3, 3)
    rotvec = se3.so3_log(smallmat.associative_scan(torch.matmul, steps))
    return RotationTable(times=times, rotvec=rotvec, mask=mask)


def interpolate_rotation(table: RotationTable, t: torch.Tensor) -> torch.Tensor:
    """Rotation vector at query times `t` (...,) -> (..., 3) by linear
    interpolation between bracketing table entries (findRotation,
    imageProjection.cpp:502-527)."""
    valid = table.mask
    tt = torch.where(valid, table.times, torch.full_like(table.times, float("inf")))
    idx_hi = torch.sum((t[..., None] >= tt).to(torch.int64), dim=-1)
    n_valid = torch.sum(valid.to(torch.int64))
    hi_max = torch.clamp(n_valid - 1, min=1)
    idx_hi = torch.minimum(torch.clamp(idx_hi, min=1), hi_max)
    idx_lo = idx_hi - 1
    t_lo = table.times[idx_lo]
    t_hi = table.times[idx_hi]
    r_lo = table.rotvec[idx_lo]
    r_hi = table.rotvec[idx_hi]
    denom = torch.clamp(t_hi - t_lo, min=1e-9)
    alpha = torch.clamp((t - t_lo) / denom, 0.0, 1.0)[..., None]
    return r_lo * (1.0 - alpha) + r_hi * alpha


def deskew(points: torch.Tensor, point_times: torch.Tensor,
           point_mask: torch.Tensor, table: RotationTable,
           pos_increment: Optional[torch.Tensor] = None,
           scan_duration: Optional[float] = None) -> torch.Tensor:
    """Motion-compensate a scan (N, 3) into its start frame:
    p' = R(t0)^{-1} (R(t) p + t(t)) (deskewPoint, imageProjection.cpp:545-575).
    Masked points pass through unchanged."""
    r0 = interpolate_rotation(table, torch.zeros((1,), dtype=points.dtype,
                                                 device=points.device))[0]
    R0 = se3.so3_exp(r0)
    Rt = se3.so3_exp(interpolate_rotation(table, point_times))  # (N, 3, 3)
    p = (Rt @ points[..., None])[..., 0]
    if pos_increment is not None and scan_duration is not None:
        ratio = torch.clamp(point_times / max(scan_duration, 1e-6), 0.0, 1.0)
        p = p + ratio[:, None] * pos_increment[None, :]
    p = p @ R0
    return torch.where(point_mask[:, None], p, points)


class DeskewInfo(NamedTuple):
    """Per-scan metadata handed to the mapping stage: the cloud_info record
    (`src/liorf/msg/cloud_info.msg`) without the ROS plumbing."""

    imu_available: torch.Tensor   # () bool, rotation table valid
    odom_available: torch.Tensor  # () bool, initial guess from IMU odometry
    imu_rpy_init: torch.Tensor    # (3,) IMU attitude at scan start (9-axis)
    initial_guess: torch.Tensor   # (6,) pose6 initial guess for registration


def make_deskew_info(imu_available, odom_available, imu_rpy_init,
                     initial_guess, device=None) -> DeskewInfo:
    return DeskewInfo(
        imu_available=torch.as_tensor(imu_available, dtype=torch.bool,
                                      device=device),
        odom_available=torch.as_tensor(odom_available, dtype=torch.bool,
                                       device=device),
        imu_rpy_init=torch.as_tensor(imu_rpy_init, dtype=torch.float32,
                                     device=device),
        initial_guess=torch.as_tensor(initial_guess, dtype=torch.float32,
                                      device=device))
