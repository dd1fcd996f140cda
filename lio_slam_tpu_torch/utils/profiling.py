"""Per-stage timer for the runner (the port's counterpart of
`lio_slam_tpu/utils/profiling.StageTimer`).

Each stage accumulates its host time (the enqueue, plus any device wait
inside the stage) and is a `torch.profiler.record_function` range, so a
profiled run reads each stage's device time from the same trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

STAGES = ("imu_predict", "deskew", "mapping_step", "full_correction",
          "imu_frontend", "loop_closure")


class StageTimer:
    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def mean_ms(self) -> dict:
        return {k: 1e3 * self.total[k] / self.count[k] for k in self.total}
