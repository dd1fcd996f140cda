"""The standard scan record the runner consumes (port of `StandardScan` in
`lio_slam_tpu/io/formats.py`; the vendor adapters are host numpy there and
not needed by the port's main path)."""

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
