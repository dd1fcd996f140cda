"""Live sensor feed — the front door for streaming missions (the port's copy
of `lio_slam_tpu/pipeline/live.py`; host-side numpy, feeding a Runner on
whatever device it was made for).

Plays the role of the reference's ROS subscriber graph (4 nodes, bounded
deques under std::mutex: cloud queue 5-deep, IMU/odom queues 2000-deep,
`imageProjection.cpp:116-118`), built on the native SPSC sample queues
(`io/native.py`): sensor callbacks push without holding the GIL on the
producer side; the driver drains per-scan windows for the device.

Semantics mirrored from ImageProjection:
- 2-scan delay buffer (cachePointCloud :214-219): a scan is processed only
  when the next one arrives, so the IMU stream covers the full sweep.
- stale-pop + bracketing window (imuDeskewInfo :359-418): per scan the IMU
  window spans the samples after those the previous scan's correction
  took, up to the sweep end; older samples are dropped permanently inside
  the queue.

Departure from the JAX feed: it starts a window 1e-9 s after the previous
scan stamp, which at epoch stamps (one float64 ulp is 2.4e-7 s) adds
nothing, while the Runner's correction takes samples up to
`CORRECTION_MARGIN` past the stamp; a sample in between was integrated by
two consecutive corrections.  Here the window starts after the samples the
previous correction took, by the correction's own rule
(`correction_takes`), so no sample is integrated twice.

A pure-python queue with identical behavior backs environments without the
native library (`use_native=False`, or `None` where it does not build).
"""

from __future__ import annotations

import bisect
from typing import Optional

import numpy as np

from lio_slam_tpu_torch.io import formats
from lio_slam_tpu_torch.io import native

# the Runner's IMU correction integrates the samples of a scan's window up
# to this far past the scan stamp (float32 offsets from it; the deskew
# table sees the whole window)
CORRECTION_MARGIN = 1e-6


def correction_takes(stamps, scan_stamp: float) -> np.ndarray:
    """Which of the (float64) sample `stamps` the correction of the scan at
    `scan_stamp` integrates: the Runner's rule, offsets rounded to float32
    as `Runner._prep_imu_window` rounds them."""
    rel = (np.asarray(stamps, np.float64) - scan_stamp).astype(np.float32)
    return rel <= CORRECTION_MARGIN


class _PySampleQueue:
    """Behavioral twin of native.SampleQueue (io/native.py)."""

    def __init__(self, dim: int, capacity: int = 4096):
        self.dim = dim
        self.capacity = capacity
        self._ts: list[float] = []
        self._vals: list[np.ndarray] = []

    def push(self, t: float, vals) -> None:
        """Sorted-insert with duplicate-stamp drop (matches the native
        queue's hostile-stream tolerance: locally out-of-order and
        duplicated messages are a fact of real vehicle logs)."""
        t = float(t)
        pos = bisect.bisect_right(self._ts, t)
        if pos > 0 and self._ts[pos - 1] == t:
            return                              # duplicate
        self._ts.insert(pos, t)
        self._vals.insert(pos, np.asarray(vals, np.float32))
        if len(self._ts) > self.capacity:
            del self._ts[0], self._vals[0]

    def window(self, t0: float, t1: float, margin: float = 0.01,
               max_n: int = 2048):
        keep = 0
        while keep < len(self._ts) and self._ts[keep] < t0 - margin:
            keep += 1
        del self._ts[:keep], self._vals[:keep]
        ts, vals = [], []
        for t, v in zip(self._ts, self._vals):
            if t > t1 or len(ts) >= max_n:
                break
            ts.append(t)
            vals.append(v)
        return (np.asarray(ts, np.float64),
                np.stack(vals) if vals else np.zeros((0, self.dim), np.float32))

    def __len__(self):
        return len(self._ts)


def _make_queue(dim: int, capacity: int, use_native: Optional[bool]):
    """(queue, native?): the native queue when `use_native` is True (a
    runtime that does not build raises) or None and it builds; the python
    twin otherwise."""
    if use_native is True or (use_native is None and native.available()):
        return native.SampleQueue(dim, capacity), True
    return _PySampleQueue(dim, capacity), False


class LiveFeed:
    """Push-style sensor API driving a Runner.

    `push_imu` / `push_gps` may be called from a feeder thread at sensor
    rate; `push_scan` runs the pipeline on the DELAYED scan (2-scan buffer)
    and returns its ScanResult (or None while the buffer fills / the
    mappingProcessInterval throttle drops it).  Call `flush()` at stream end
    for the final scan.  `native_active` says which queue holds the IMU."""

    IMU_DIM = 10     # acc(3) gyr(3) quat(4; NaN when absent)

    def __init__(self, runner, imu_capacity: int = 4096,
                 use_native: Optional[bool] = None):
        self.runner = runner
        self.imu_queue, self.native_active = _make_queue(
            self.IMU_DIM, imu_capacity, use_native)
        self._pending: Optional[formats.StandardScan] = None
        self._last_scan_stamp: Optional[float] = None
        self._last_pushed_scan: Optional[float] = None
        # corrected-GPS queue: every fix is kept and scanned per keyframe
        # within +-0.2 s, the reference's gpsQueue semantics
        # (addGPSFactor, mapOptmization.cpp:1961-1976)
        self._gps_queue: list[tuple] = []
        self.gps_pair_window = 0.2   # reference window (:1966-1970)
        # deskew needs the rotation table to extend past the sweep tail —
        # the reference integrates IMU to currentScanTime + 0.01
        # (imuDeskewInfo bracketing); tail samples are NOT consumed, so the
        # next correction window still integrates them
        self.deskew_tail_margin = 0.01

    # -- producers ---------------------------------------------------------

    def push_imu(self, t: float, acc, gyr, quat=None) -> None:
        rec = np.empty(self.IMU_DIM, np.float32)
        rec[0:3] = np.asarray(acc, np.float32)
        rec[3:6] = np.asarray(gyr, np.float32)
        rec[6:10] = (np.asarray(quat, np.float32) if quat is not None
                     else np.nan)
        self.imu_queue.push(t, rec)

    def push_gps(self, t: float, lat: float, lon: float, alt: float,
                 status: int = 0, covariance=None, heading=None) -> None:
        """Corrected GPS stream ("GPSmsg" role): queued (every fix) and
        scanned per scan as factor candidates; marks the FSM's corrected-side
        timestamp at arrival (data time)."""
        self._gps_queue.append((float(t), lat, lon, alt, status, covariance))
        if len(self._gps_queue) > 4096:
            del self._gps_queue[0]
        self.runner.fsm.on_gps(float(t))

    def push_raw_gps(self, t: float, lat: float = None, lon: float = None,
                     alt: float = None, heading: float = None) -> int:
        """Raw vehicle GPS ("gpsdata" role): steps the positioning-mode FSM
        and feeds the sensor_fusion_output arbitration."""
        return self.runner.on_raw_gps(t, lat, lon, alt, heading=heading)

    def push_scan(self, scan: formats.StandardScan):
        # non-increasing scan stamps = duplicated or misordered lidar
        # messages — dropped (the mapping step's state is strictly forward
        # in time; the reference would process the duplicate and emit a
        # zero-motion step)
        if (self._last_pushed_scan is not None
                and float(scan.stamp) <= self._last_pushed_scan):
            return None
        self._last_pushed_scan = float(scan.stamp)
        if self._pending is None:
            self._pending = scan
            return None
        self._pending, scan = scan, self._pending
        return self._process(scan)

    def flush(self):
        """Stream end: process the delayed final scan."""
        if self._pending is None:
            return None
        scan, self._pending = self._pending, None
        return self._process(scan)

    # -- internals ---------------------------------------------------------

    def _window_for(self, scan: formats.StandardScan) -> Optional[dict]:
        sweep_end = float(scan.stamp) + (float(scan.time.max())
                                         if scan.time is not None
                                         and len(scan.time) else 0.0)
        # the window starts after the samples the previous scan's correction
        # took (imuQueOpt pop semantics): those before its stamp leave the
        # queue for good (margin 0), those up to CORRECTION_MARGIN past it
        # are skipped here and leave at the next window
        last = self._last_scan_stamp
        ts, vals = self.imu_queue.window(
            last if last is not None else -1e18,
            sweep_end + self.deskew_tail_margin, margin=0.0, max_n=4096)
        if last is not None and len(ts):
            fresh = ~correction_takes(ts, last)
            ts, vals = ts[fresh], vals[fresh]
        if len(ts) == 0:
            return None
        quat = vals[:, 6:10]
        return {"stamps": ts, "acc": vals[:, 0:3].copy(),
                "gyr": vals[:, 3:6].copy(),
                "quat": None if np.isnan(quat).all() else quat.copy()}

    def _process(self, scan: formats.StandardScan):
        imu = self._window_for(scan)
        # queue-scan pairing (addGPSFactor :1961-1976): drop fixes older
        # than scan-window, consume every fix inside +-gps_pair_window as a
        # candidate (in time order), keep newer fixes for the next scan
        t = float(scan.stamp)
        w = self.gps_pair_window
        fixes, keep = [], []
        for rec in self._gps_queue:
            if rec[0] < t - w:
                continue                       # stale — pop permanently
            (fixes if rec[0] <= t + w else keep).append(rec)
        self._gps_queue = keep
        self._last_scan_stamp = t
        return self.runner.process_scan(scan, imu=imu,
                                        gps_fixes=fixes or None)
