"""Scan Context place recognition (port of `lio_slam_tpu/ops/scancontext.py`,
Scancontext.cpp, Kim & Kim IROS 2018).

- descriptor (`makeScancontext`, :151-195): 20-ring x 60-sector polar image
  of max z; ring key (:198-227): row means.  `_save_keyframe` stores both.
- retrieval (`detectLoopClosureID`, :253-342): every ring-key distance in
  one op (the database is at most max_keyframes x 20), the nearest
  candidates older than the most recent `exclude_recent`.
- alignment (`distanceBtnScanContext`, :116-148): the column-shifted cosine
  distance at all 60 shifts at once; the best shift is the yaw guess.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lio_slam_tpu_torch.utils.resident import set_at_

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
    set_at_(descriptors, i, desc)
    set_at_(ring_keys, i, ring_key(desc))
    return ScanContextDB(descriptors=descriptors, ring_keys=ring_keys,
                         count=torch.clamp(db.count + 1, max=K))


def _sc_distance_all_shifts(query: torch.Tensor,
                            cands: torch.Tensor) -> torch.Tensor:
    """Column-shifted cosine distance between `query` (R,S) and candidate
    descriptors (C,R,S) for all S shifts -> (C, S).  distDirectSC (:93-113):
    the mean over columns of (1 - cos(col_q, col_c)), empty columns
    skipped."""
    S = query.shape[-1]
    shifts = torch.stack([torch.roll(query, -s, dims=-1) for s in range(S)])
    qn = torch.linalg.norm(shifts, dim=-2)                    # (S, S) col norms
    cn = torch.linalg.norm(cands, dim=-2)                     # (C, S)
    dots = torch.einsum("srk,crk->csk", shifts, cands)        # (C, S, S)
    denom = qn[None, :, :] * cn[:, None, :]
    cos = torch.where(denom > 1e-9, dots / torch.clamp(denom, min=1e-9),
                      torch.zeros_like(dots))
    col_valid = (qn[None, :, :] > 1e-9) & (cn[:, None, :] > 1e-9)
    n_valid = torch.clamp(torch.sum(col_valid, dim=-1), min=1)
    return torch.sum(torch.where(col_valid, 1.0 - cos, torch.zeros_like(cos)),
                     dim=-1) / n_valid


class SCMatch(NamedTuple):
    index: torch.Tensor      # () int32 matched keyframe (-1 if none)
    distance: torch.Tensor   # () best descriptor distance
    yaw: torch.Tensor        # () rad: yaw of the match (shift * 2pi/S)


def detect(db: ScanContextDB, query_desc: torch.Tensor,
           dist_threshold: float = 0.3, num_candidates: int = 3,
           exclude_recent: int = 30) -> SCMatch:
    """detectLoopClosureID: ring-key k-NN -> shifted cosine distance -> gate.
    Nothing here waits for the device."""
    K = db.descriptors.shape[0]
    dev = query_desc.device
    inf = torch.full((), float("inf"), dtype=query_desc.dtype, device=dev)
    d_ring = torch.linalg.norm(db.ring_keys - ring_key(query_desc)[None, :],
                               dim=-1)
    eligible = torch.arange(K, device=dev) < (db.count - exclude_recent)
    d_ring = torch.where(eligible, d_ring, inf)
    cand_idx = torch.topk(-d_ring, num_candidates).indices     # (C,)
    cand_ok = torch.isfinite(d_ring[cand_idx])
    dist = _sc_distance_all_shifts(query_desc, db.descriptors[cand_idx])
    best_dist, best_shift = torch.min(dist, dim=-1)            # (C,)
    best_dist = torch.where(cand_ok, best_dist, inf)
    b = torch.argmin(best_dist)
    accept = best_dist[b] < dist_threshold
    S = query_desc.shape[-1]
    # sign: a query pose yawed +theta relative to the match sees world
    # content at body azimuth -theta, i.e. columns shifted DOWN; the matching
    # circshift s therefore corresponds to yaw = -s * 2pi/S
    yaw = -best_shift[b].to(torch.float32) * (2.0 * math.pi / S)
    yaw = torch.where(yaw < -math.pi, yaw + 2 * math.pi, yaw)
    return SCMatch(
        index=torch.where(accept, cand_idx[b].to(torch.int32),
                          torch.full((), -1, dtype=torch.int32, device=dev)),
        distance=best_dist[b],
        yaw=torch.where(accept, yaw, torch.zeros_like(yaw)))
