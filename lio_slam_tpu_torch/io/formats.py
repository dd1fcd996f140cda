"""Vendor point-format normalization (host-side numpy; the port's own copy
of `lio_slam_tpu/io/formats.py`).

Rebuild of the reference's sensor-adaptation layer:

- the per-vendor converters in `imageProjection.cpp:224-286` (Velodyne
  passthrough, Ouster ns->s + staggered time, Robosense double timestamps,
  Mulran per-scan offsets, Livox line->ring)
- the standalone `rs_to_velodyne` node (`src/rs_to_velodyne/src/
  rs_to_velodyne.cpp`): NaN removal, 16/128-beam ring remap tables, XYZI
  ring synthesis from elevation angle.

Every adapter returns a `StandardScan`: float32 xyz, intensity, uint16 ring,
float32 time relative to scan start — the Velodyne XYZIRT layout every
downstream stage assumes.  Absolute timestamps (Robosense, Mulran) are
rebased in float64 before the cast: at epoch magnitude a float32 keeps
nothing below 128 s.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class StandardScan:
    xyz: np.ndarray        # (N, 3) float32
    intensity: np.ndarray  # (N,) float32
    ring: np.ndarray       # (N,) uint16
    time: np.ndarray       # (N,) float32 seconds relative to scan start
    stamp: float           # scan-start wall time


def _drop_nan(xyz, *arrays):
    ok = np.isfinite(xyz).all(axis=1)
    return (xyz[ok],) + tuple(a[ok] for a in arrays)


def from_velodyne(xyz, intensity, ring, time, stamp: float) -> StandardScan:
    """Native XYZIRT — passthrough with NaN removal."""
    xyz = np.asarray(xyz, np.float32)
    xyz, intensity, ring, time = _drop_nan(
        xyz, np.asarray(intensity, np.float32),
        np.asarray(ring, np.uint16), np.asarray(time, np.float32))
    return StandardScan(xyz, intensity, ring, time, stamp)


def from_ouster(xyz, intensity, ring, t_ns, stamp: float) -> StandardScan:
    """Ouster: t is nanoseconds since scan start (imageProjection.cpp:244-258)."""
    time = np.asarray(t_ns, np.float64) * 1e-9
    return from_velodyne(xyz, intensity, ring, time.astype(np.float32), stamp)


def from_robosense(xyz, intensity, ring, timestamp_abs, stamp: float) -> StandardScan:
    """Robosense: absolute double timestamps per point (:260-274)."""
    ts = np.asarray(timestamp_abs, np.float64)
    t0 = ts.min() if len(ts) else stamp
    time = (ts - t0).astype(np.float32)
    return from_velodyne(xyz, intensity, ring, time, float(t0))


def from_mulran(xyz, intensity, ring, t_abs_us, stamp: float) -> StandardScan:
    """Mulran Ouster: per-point absolute microseconds (:276-286)."""
    ts = np.asarray(t_abs_us, np.float64) * 1e-6
    t0 = ts.min() if len(ts) else 0.0
    return from_velodyne(xyz, intensity, ring, (ts - t0).astype(np.float32), stamp)


def from_livox(xyz, intensity, line, time, stamp: float) -> StandardScan:
    """Livox: 'line' plays the ring role."""
    return from_velodyne(xyz, intensity, np.asarray(line, np.uint16), time, stamp)


# ---------------------------------------------------------------------------
# rs_to_velodyne equivalents
# ---------------------------------------------------------------------------

# RS16 fires rings in an interleaved order (rs_to_velodyne.cpp:12-15)
RS16_REMAP = np.array(
    [0, 2, 4, 6, 8, 10, 12, 14, 15, 13, 11, 9, 7, 5, 3, 1], np.uint16)

# RS128 remap (rs_to_velodyne.cpp:17-25): hardware row -> velodyne-style ring
RS128_REMAP = np.array([int(i / 4) + (i % 4) * 32 for i in range(128)], np.uint16)


def remap_ring_rs16(ring):
    return RS16_REMAP[np.asarray(ring, np.int64)]


def remap_ring_rs128(ring):
    return RS128_REMAP[np.asarray(ring, np.int64)]


def ring_from_elevation(xyz, n_scan: int = 16,
                        fov_down_deg: float = -15.0,
                        fov_up_deg: float = 15.0):
    """Synthesize ring ids from the vertical angle (rs_to_velodyne's
    XYZI->XYZIR mode, :85-132: RS16 elevation binning)."""
    xyz = np.asarray(xyz, np.float64)
    d = np.linalg.norm(xyz[:, :2], axis=1)
    elev = np.rad2deg(np.arctan2(xyz[:, 2], np.maximum(d, 1e-9)))
    frac = (elev - fov_down_deg) / max(fov_up_deg - fov_down_deg, 1e-9)
    ring = np.clip(np.round(frac * (n_scan - 1)), 0, n_scan - 1)
    return ring.astype(np.uint16)


def synthesize_time_from_azimuth(xyz, scan_period: float = 0.1):
    """Relative per-point time from azimuth when the vendor omits it (the
    XYZIR mode: deskew still needs timestamps)."""
    theta = np.arctan2(xyz[:, 1], xyz[:, 0])
    frac = (theta + np.pi) / (2 * np.pi)
    return (frac * scan_period).astype(np.float32)


ADAPTERS = {
    "velodyne": from_velodyne,
    "ouster": from_ouster,
    "robosense": from_robosense,
    "mulran": from_mulran,
    "livox": from_livox,
}
