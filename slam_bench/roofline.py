"""The fused correspondence kernel's least time on the card: a frozen copy
of the port's `chip_smoke.kernel_bound` count, and the card's peaks.

Bytes: the filled slots of each distinct bucket row that some unmasked
point names (12 bytes a slot) and the row's count once; ids, scan, mask
and pose once; the 45 output words once.  Operations: 8 a filled
candidate distance each unmasked point scans (a repeated id once), about
300 a plane fit.  The bound is the larger of bytes over the card's
bandwidth and operations over its float32 rate.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM (80 GB HBM3), published, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def kernel_bound_s(T: int, C: int, hh: torch.Tensor, mask: torch.Tensor,
                   counts: torch.Tensor | None) -> float:
    """Seconds: the least the card could take for one launch on bucket ids
    `hh` (O, N) into a (T, C, 3) table filled to `counts` (T,) (whole
    rows where None), for the unmasked points of `mask` (N,)."""
    ok = (hh >= 0) & (hh < T)
    live = hh[:, mask][ok[:, mask]]
    rows = torch.unique(live)
    if counts is None:
        counts = torch.full((T,), C, dtype=torch.int32, device=hh.device)
    filled = int(counts[rows.long()].clamp(0, C).sum())
    fixed = hh.numel() * 4 + mask.numel() * 12 + mask.numel() + 6 * 4 + 45 * 4
    n_bytes = filled * 12 + rows.numel() * 4 + fixed
    per_slot = torch.where(ok, counts[hh.clamp(0, T - 1).long()].clamp(0, C),
                           torch.zeros_like(hh))
    first = torch.ones_like(ok)
    for o in range(1, hh.shape[0]):
        first[o] = (hh[:o] != hh[o]).all(0)
    scanned = int((per_slot * first)[:, mask].sum())
    flop = scanned * 8 + int(mask.sum()) * 300
    return max(n_bytes / HBM_BYTES_PER_S, flop / FP32_FLOP_PER_S)
