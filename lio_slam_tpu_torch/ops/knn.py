"""Exact k-nearest-neighbour search over masked point sets (port of
`lio_slam_tpu/ops/knn.py`): the brute-force backend of `register` and the
corner term's 5-NN among map edge points.

Squared distances come from one matmul per reference chunk,
‖q‖² + ‖r‖² − 2 q·rᵀ, as the reference computes them (the cancellation of
that form at tens of metres is part of what the 5th neighbour's radius gate
sees, so it is kept), with a running top-k over the chunks.  Ties keep the
lower index, as `lax.top_k` does: `torch.topk`, whose order among equal
keys is not fixed, runs on keys made distinct by the position.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_BIG = 1e30


class KnnResult(NamedTuple):
    idx: torch.Tensor    # (N, k) int32 indices into the reference set
    dist2: torch.Tensor  # (N, k) squared distances (1e30 for invalid)
    valid: torch.Tensor  # (N, k) bool — neighbour exists and is a real point


def _smallest_k(d: torch.Tensor, k: int) -> torch.Tensor:
    """Positions (N, k) of the k smallest entries of each row of the
    float32 `d`, ascending, ties in position order (a stable sort's first
    k).  Each entry's key is its float's bits, made to order as signed
    integers, above its position: the keys are distinct, so `torch.topk`
    has no tie to order."""
    bits = d.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    pos = torch.arange(d.shape[1], dtype=torch.int64, device=d.device)
    key = (ordered.to(torch.int64) << 32) | pos
    return torch.topk(key, k, dim=1, largest=False, sorted=True).indices


def knn(query: torch.Tensor, query_mask: torch.Tensor,
        ref: torch.Tensor, ref_mask: torch.Tensor,
        k: int = 5, chunk: int = 4096) -> KnnResult:
    """Exact k-NN of `query` (N,3) against `ref` (M,3), masked.  Invalid
    reference points are never neighbours; invalid queries get all-invalid
    results."""
    N = query.shape[0]
    M = ref.shape[0]
    dev = query.device
    chunk = min(chunk, M)
    n_chunks = (M + chunk - 1) // chunk
    pad = n_chunks * chunk - M
    if pad:
        ref = torch.cat([ref, torch.zeros((pad, 3), dtype=ref.dtype, device=dev)])
        ref_mask = torch.cat([ref_mask, torch.zeros(pad, dtype=torch.bool,
                                                    device=dev)])
    q2 = torch.sum(query * query, dim=-1, keepdim=True)          # (N, 1)
    big = torch.full((), _BIG, dtype=torch.float32, device=dev)
    best_d = torch.full((N, k), _BIG, dtype=torch.float32, device=dev)
    best_i = torch.zeros((N, k), dtype=torch.int32, device=dev)
    for c in range(n_chunks):
        r = ref[c * chunk:(c + 1) * chunk]
        rm = ref_mask[c * chunk:(c + 1) * chunk]
        r2 = torch.sum(r * r, dim=-1)[None, :]                    # (1, C)
        d2 = q2 + r2 - 2.0 * torch.matmul(query, r.T)
        d2 = torch.where(rm[None, :], d2, big)
        cand_d = torch.cat([best_d, d2], dim=1)                   # (N, k+C)
        base = torch.arange(c * chunk, (c + 1) * chunk, dtype=torch.int32,
                            device=dev)
        cand_i = torch.cat([best_i, base[None, :].expand(N, chunk)], dim=1)
        sel = _smallest_k(cand_d, k)
        best_d = torch.gather(cand_d, 1, sel)
        best_i = torch.gather(cand_i, 1, sel)
    valid = (best_d < _BIG) & query_mask[:, None]
    best_d = torch.clamp(best_d, min=0.0)
    return KnnResult(idx=best_i, dist2=torch.where(valid, best_d, big),
                     valid=valid)


def radius_neighbors_mask(query: torch.Tensor, ref: torch.Tensor,
                          ref_mask: torch.Tensor, radius: float) -> torch.Tensor:
    """Boolean mask (M,) of the reference points within `radius` of one
    query point: the keypose radius search (mapOptmization.cpp:1527) on a
    masked pose array."""
    d2 = torch.sum((ref - query[None, :]) ** 2, dim=-1)
    return ref_mask & (d2 <= radius * radius)
