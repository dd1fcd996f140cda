"""Scan Context descriptors (port of the descriptor part of
`lio_slam_tpu/ops/scancontext.py`, Scancontext.cpp:151-227).

Retrieval (`detect`) belongs to loop closure, which the port does not run
yet; `_save_keyframe` only builds and stores descriptors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

NUM_RING = 20
NUM_SECTOR = 60


class ScanContextDB(NamedTuple):
    descriptors: torch.Tensor   # (K, R, S)
    ring_keys: torch.Tensor     # (K, R)
    count: torch.Tensor         # () int32


def empty_db(max_keyframes: int, num_ring: int = NUM_RING,
             num_sector: int = NUM_SECTOR, device=None) -> ScanContextDB:
    return ScanContextDB(
        descriptors=torch.zeros((max_keyframes, num_ring, num_sector),
                                dtype=torch.float32, device=device),
        ring_keys=torch.zeros((max_keyframes, num_ring), dtype=torch.float32,
                              device=device),
        count=torch.zeros((), dtype=torch.int32, device=device))


def make_descriptor(xyz: torch.Tensor, mask: torch.Tensor,
                    max_radius: float = 80.0, lidar_height: float = 2.0,
                    num_ring: int = NUM_RING,
                    num_sector: int = NUM_SECTOR) -> torch.Tensor:
    """Polar max-z image of a body-frame scan (makeScancontext); empty bins
    are 0.  A scatter-max: the maximum does not depend on the order."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x)
    theta = torch.where(theta < 0, theta + 2 * math.pi, theta)
    ring = torch.clamp((r / max_radius * num_ring).to(torch.int32), 0, num_ring - 1)
    sector = torch.clamp((theta / (2 * math.pi) * num_sector).to(torch.int32),
                         0, num_sector - 1)
    ok = mask & (r < max_radius)
    bins = num_ring * num_sector
    idx = torch.where(ok, ring * num_sector + sector,
                      torch.full_like(ring, bins)).to(torch.int64)
    zval = torch.where(ok, z + lidar_height, torch.full_like(z, -float("inf")))
    img = torch.full((bins + 1,), -float("inf"), dtype=xyz.dtype,
                     device=xyz.device).scatter_reduce(0, idx, zval, "amax")
    img = img[:bins].reshape(num_ring, num_sector)
    return torch.where(torch.isfinite(img), img, torch.zeros_like(img))


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Row means (makeRingkeyFromScancontext)."""
    return torch.mean(desc, dim=-1)


def add_descriptor(db: ScanContextDB, desc: torch.Tensor) -> ScanContextDB:
    K = db.descriptors.shape[0]
    i = torch.clamp(db.count, max=K - 1).to(torch.int64)
    descriptors = db.descriptors.clone()
    ring_keys = db.ring_keys.clone()
    descriptors[i] = desc
    ring_keys[i] = ring_key(desc)
    return ScanContextDB(descriptors=descriptors, ring_keys=ring_keys,
                         count=torch.clamp(db.count + 1, max=K))
