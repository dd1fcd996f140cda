"""LOAM corner / surface features over a range image (port of
`lio_slam_tpu/ops/features.py`, featureExtraction.cpp:81-237 semantics):

- `project_range_image`: the organized (R, H) range image and index map of
  an unorganized scan with ring ids (imageProjection.cpp:577-615);
- `extract_features`: curvature over +-5 in-ring neighbours, occlusion and
  parallel-beam masking, per ring 6 sectors of at most 20 edges with +-5
  non-max suppression, surface points below the surface threshold.

Both are written so that the card gives the CPU's answer: a pixel's point
is chosen by two reductions, not by duplicate-index writes, and the
sector's greedy suppression is 40 tensor steps over every sector at once.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Features(NamedTuple):
    curvature: torch.Tensor   # (R, H)
    edge_mask: torch.Tensor   # (R, H) selected corner points
    surf_mask: torch.Tensor   # (R, H) surface candidates
    valid: torch.Tensor       # (R, H) usable points after masking


def _pick_sectors(c_sec: torch.Tensor, edge_threshold: float,
                  max_edges: int) -> torch.Tensor:
    """Greedy top-k edge pick with +-5 suppression in each row of `c_sec`
    (S, w): the 2 * max_edges largest curvatures in descending order (ties:
    lower index first, as `lax.top_k`), each taken when above the threshold,
    more than 5 indices from every point taken before it and while fewer
    than `max_edges` are taken.  Returns the (S, w) mask of taken points."""
    S, w = c_sec.shape
    k = min(max_edges * 2, w)
    order = torch.sort(c_sec, dim=1, descending=True, stable=True).indices[:, :k]
    top_c = torch.gather(c_sec, 1, order)
    taken = torch.full((S, k), -1000, dtype=torch.int64, device=c_sec.device)
    n_taken = torch.zeros(S, dtype=torch.int64, device=c_sec.device)
    picked = torch.zeros((S, k), dtype=torch.bool, device=c_sec.device)
    rows = torch.arange(S, device=c_sec.device)
    for j in range(k):
        c, i = top_c[:, j], order[:, j]
        near = torch.any(torch.abs(taken - i[:, None]) <= 5, dim=1)
        ok = (c > edge_threshold) & ~near & (n_taken < max_edges)
        slot = n_taken % k
        taken[rows, slot] = torch.where(ok, i, taken[rows, slot])
        n_taken = n_taken + ok.to(torch.int64)
        picked[:, j] = ok
    mask = torch.zeros((S, w), dtype=torch.bool, device=c_sec.device)
    return mask.scatter(1, order, picked)


def extract_features(ranges: torch.Tensor, valid: torch.Tensor,
                     edge_threshold: float = 1.0,
                     surf_threshold: float = 0.1,
                     num_sectors: int = 6,
                     max_edges_per_sector: int = 20) -> Features:
    """ranges: (R, H) range image (0 or garbage where ~valid).

    Each ring is compacted (valid pixels first, column order kept) before
    the neighbourhood ops, as the reference iterates the compacted per-ring
    point vector; the masks come back in the (R, H) layout."""
    R, H = ranges.shape
    dev = ranges.device
    order = torch.argsort((~valid).to(torch.int32), dim=1, stable=True)
    rC = torch.gather(ranges, 1, order)
    vC = torch.gather(valid, 1, order)
    colC = order
    nv = torch.sum(valid.to(torch.int64), dim=1)
    pos = torch.arange(H, device=dev)[None, :]
    in_core = (pos >= 5) & (pos < nv[:, None] - 5) & vC

    r = torch.where(vC, rC, torch.zeros_like(rC))
    # curvature: (sum over +-5 compacted neighbours of r_j - r_0)^2.  The
    # reference's compiler fuses the first step, -10 r + r_{i-5}, into one
    # multiply-add (one rounding): done in float64 here, where -10 r is
    # exact, it rounds once too, and near-equal curvatures order as there
    acc = (-10.0 * r.double() + torch.roll(r, 5, dims=1).double()).float()
    for j in list(range(-4, 0)) + list(range(1, 6)):
        acc = acc + torch.roll(r, -j, dims=1)
    curv = acc * acc

    # occlusion: neighbours within 10 original columns with a range jump
    # over 0.3 m mark the farther side's 5-6 points unusable
    r_next = torch.roll(r, -1, dims=1)
    near_cols = torch.abs(torch.roll(colC, -1, dims=1) - colC) < 10
    jump = torch.where(near_cols, r_next - r, torch.zeros_like(r))
    occl_self = jump < -0.3
    occl_next = jump > 0.3
    occluded = torch.zeros_like(vC)
    for j in range(0, 6):
        occluded = occluded | torch.roll(occl_self, j, dims=1)
    for j in range(1, 7):
        occluded = occluded | torch.roll(occl_next, j, dims=1)
    # parallel beam: both neighbours differ by more than 2 % of the range
    d_prev = torch.abs(torch.roll(r, 1, dims=1) - r)
    d_next = torch.abs(r_next - r)
    parallel = (d_prev > 0.02 * r) & (d_next > 0.02 * r)

    usable = in_core & ~occluded & ~parallel

    # sectors over the compacted index (6 equal index spans a ring)
    sector_w = H // num_sectors
    curv_use = torch.where(usable, curv, torch.full_like(curv, -1.0))
    sectors = curv_use[:, :sector_w * num_sectors].reshape(R * num_sectors,
                                                           sector_w)
    edge_sec = _pick_sectors(sectors, edge_threshold, max_edges_per_sector)
    edgeC = torch.zeros((R, H), dtype=torch.bool, device=dev)
    edgeC[:, :sector_w * num_sectors] = edge_sec.reshape(
        R, num_sectors * sector_w)
    edgeC = edgeC & usable
    surfC = usable & (curv < surf_threshold) & ~edgeC

    # back to the original columns (the compaction is a permutation a row)
    def back(mC):
        out = torch.zeros((R, H), dtype=mC.dtype, device=dev)
        return out.scatter(1, colC, torch.where(vC, mC, torch.zeros_like(mC)))

    return Features(curvature=back(curv), edge_mask=back(edgeC),
                    surf_mask=back(surfC), valid=back(usable))


def project_range_image(xyz: torch.Tensor, mask: torch.Tensor,
                        ring: torch.Tensor, n_scan: int, horizon: int):
    """Organized (R, H) range image and index map of an unorganized scan
    with ring ids (the projectPointCloud step, imageProjection.cpp:577-615).
    A pixel keeps its closest point; among points at that same range, the
    one of the highest index (the reference's last write over its stable
    descending order by range).

    Returns (ranges (R,H), valid (R,H), index (R,H) into the input arrays,
    -1 where empty)."""
    N = xyz.shape[0]
    dev = xyz.device
    P = n_scan * horizon
    r = torch.linalg.norm(xyz, dim=-1)
    theta = torch.atan2(xyz[:, 1], xyz[:, 0])
    col = ((theta + math.pi) / (2 * math.pi) * horizon).to(torch.int32)
    col = torch.clamp(col, 0, horizon - 1)
    row = torch.clamp(ring.to(torch.int32), 0, n_scan - 1)
    flat = torch.where(mask, row * horizon + col,
                       torch.full_like(row, P)).to(torch.int64)
    inf = torch.full((P + 1,), math.inf, dtype=r.dtype, device=dev)
    r_in = torch.where(mask, r, torch.full_like(r, math.inf))
    best = inf.scatter_reduce(0, flat, r_in, "amin")
    idx = torch.arange(N, device=dev)
    wins = mask & (r_in == best[flat])
    idx_img = torch.full((P + 1,), -1, dtype=torch.int64, device=dev)
    idx_img = idx_img.scatter_reduce(
        0, flat, torch.where(wins, idx, torch.full_like(idx, -1)), "amax")
    ranges = best[:-1].reshape(n_scan, horizon)
    idx_img = idx_img[:-1].reshape(n_scan, horizon).to(torch.int32)
    valid = torch.isfinite(ranges)
    return torch.where(valid, ranges, torch.zeros_like(ranges)), valid, idx_img
