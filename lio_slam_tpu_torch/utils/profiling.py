"""Per-stage timing and rate monitoring (port of
`lio_slam_tpu/utils/profiling.py`; the reference's TicToc stopwatch and the
`rostopic hz` health check).

- `StageTimer`: named stages with count, total, max, EMA and the last
  duration, a one-line-a-stage report.  Each stage accumulates its host
  time (the enqueue, plus any device wait inside the stage) and is a
  `torch.profiler.record_function` range, so a profiled run reads each
  stage's device time from the same trace.
- `RateMonitor`: a stream's arrival rate against its expected rate.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

STAGES = ("imu_predict", "deskew", "mapping_step", "full_correction",
          "imu_frontend", "loop_closure", "archive_loop", "host_fetch")


@dataclass
class StageStats:
    count: int = 0
    total: float = 0.0
    max: float = 0.0
    ema: float = 0.0
    last_dt: float = 0.0

    def update(self, dt: float, alpha: float = 0.1):
        self.count += 1
        self.total += dt
        self.max = max(self.max, dt)
        self.ema = dt if self.count == 1 else (1 - alpha) * self.ema + alpha * dt
        self.last_dt = dt


class StageTimer:
    def __init__(self):
        self.stats: Dict[str, StageStats] = defaultdict(StageStats)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.stats[name].update(time.perf_counter() - t0)

    def record(self, name: str, dt: float):
        self.stats[name].update(dt)

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stats.items()):
            mean = s.total / max(s.count, 1)
            lines.append(f"{name:>24s}: n={s.count:5d} mean={mean * 1e3:8.2f}ms "
                         f"ema={s.ema * 1e3:8.2f}ms max={s.max * 1e3:8.2f}ms")
        return "\n".join(lines)

    def last(self) -> dict:
        """Most recent duration per stage (seconds): per-step logging."""
        return {k: v.last_dt for k, v in self.stats.items()}

    def as_dict(self) -> dict:
        return {k: {"count": v.count, "mean_ms": v.total / max(v.count, 1) * 1e3,
                    "max_ms": v.max * 1e3}
                for k, v in self.stats.items()}


@dataclass
class RateMonitor:
    """`rostopic hz` equivalent: the arrival rate of a stream, and whether
    it departs from the expected rate (README.md:308-322 records ~10 Hz on
    7 topics as the health check)."""

    expected_hz: float
    tolerance: float = 0.3        # fraction
    window: int = 50
    _stamps: list = field(default_factory=list)

    def tick(self, stamp: Optional[float] = None):
        self._stamps.append(time.time() if stamp is None else stamp)
        if len(self._stamps) > self.window:
            self._stamps.pop(0)

    @property
    def hz(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        span = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / span if span > 0 else 0.0

    @property
    def healthy(self) -> bool:
        if len(self._stamps) < max(3, self.window // 5):
            return True            # not enough data to judge
        return abs(self.hz - self.expected_hz) <= self.tolerance * self.expected_hz
