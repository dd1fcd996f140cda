"""2.5D elevation / occupancy rasterization (port of
`lio_slam_tpu/ops/heightmap.py`; the reference's grid_map_pcl loader,
`grid_map_pcl_loader_node.cpp:45-72`, and the grid_map filter / SDF layers).

`rasterize` is one scatter-max (elevation), one scatter-min and an int32
count over a fixed grid centred on the vehicle.  `scatter_reduce` with
amax / amin and an integer sum give the same bits in any order, so the
CUDA atomics behind them leave the result deterministic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class HeightMap(NamedTuple):
    elevation: torch.Tensor   # (H, W) max z per cell (NaN where empty)
    min_z: torch.Tensor       # (H, W) min z per cell
    count: torch.Tensor       # (H, W) int32 points per cell
    origin: torch.Tensor      # (2,) world xy of the cell (0, 0) corner
    resolution: torch.Tensor  # () metres per cell


def rasterize(xyz: torch.Tensor, mask: torch.Tensor, center_xy: torch.Tensor,
              resolution: float = 0.2, shape: tuple = (512, 512)) -> HeightMap:
    """Scatter a masked cloud into an elevation grid centred on `center_xy`."""
    H, W = shape
    dev = xyz.device
    res = torch.tensor(resolution, dtype=torch.float32, device=dev)
    origin = center_xy - torch.tensor([H, W], dtype=torch.float32,
                                      device=dev) * res / 2.0
    ij = torch.floor((xyz[:, :2] - origin[None, :]) / res).to(torch.int32)
    inb = (mask & (ij[:, 0] >= 0) & (ij[:, 0] < H) & (ij[:, 1] >= 0)
           & (ij[:, 1] < W))
    flat = torch.where(inb, ij[:, 0] * W + ij[:, 1],
                       torch.full_like(ij[:, 0], H * W)).to(torch.int64)
    z = xyz[:, 2]
    inf = torch.full_like(z, float("inf"))
    elev = torch.full((H * W + 1,), -float("inf"), dtype=z.dtype,
                      device=dev).scatter_reduce(0, flat, torch.where(inb, z, -inf),
                                                 "amax")
    mins = torch.full((H * W + 1,), float("inf"), dtype=z.dtype,
                      device=dev).scatter_reduce(0, flat, torch.where(inb, z, inf),
                                                 "amin")
    cnt = torch.zeros(H * W + 1, dtype=torch.int32, device=dev).index_add_(
        0, flat, inb.to(torch.int32))
    elev = elev[:-1].reshape(H, W)
    mins = mins[:-1].reshape(H, W)
    cnt = cnt[:-1].reshape(H, W)
    empty = cnt == 0
    nan = torch.full_like(elev, float("nan"))
    return HeightMap(elevation=torch.where(empty, nan, elev),
                     min_z=torch.where(empty, nan, mins),
                     count=cnt, origin=origin, resolution=res)


def inpaint_nearest(hm: HeightMap, iterations: int = 4) -> torch.Tensor:
    """Fill empty cells from neighbour means (a coarse grid_map_cv
    inpainting): a few Jacobi passes."""
    nan = torch.isnan(hm.elevation)
    e = torch.where(nan, torch.zeros_like(hm.elevation), hm.elevation)
    known = (~nan).to(torch.float32)
    H, W = e.shape
    row = torch.arange(H, device=e.device)[:, None]
    col = torch.arange(W, device=e.device)[None, :]
    # validity of each rolled-in neighbour: roll wraps, and the opposite map
    # edge must not bleed into border cells
    inb = {(1, 0): row >= 1, (-1, 0): row < H - 1,
           (1, 1): col >= 1, (-1, 1): col < W - 1}
    for _ in range(iterations):
        ksum = sum(torch.roll(known, d, ax) * inb[(d, ax)] for d, ax in inb)
        esum = sum(torch.roll(e * known, d, ax) * inb[(d, ax)] for d, ax in inb)
        fill_now = (known == 0) & (ksum > 0)
        e = torch.where(fill_now, esum / torch.clamp(ksum, min=1), e)
        known = torch.where(fill_now, torch.ones_like(known), known)
    return torch.where(known > 0, e, torch.full_like(e, float("nan")))


def normals_and_slope(hm: HeightMap):
    """Surface normals (H, W, 3) and slope (H, W, rad) from the elevation
    layer by central differences (grid_map_filters' NormalVectorsFilter /
    SlopeFilter); one-sided at NaN or border neighbours; NaN cells stay
    NaN."""
    e = hm.elevation
    res = hm.resolution
    ok = ~torch.isnan(e)
    filled = torch.where(ok, e, torch.zeros_like(e))

    def shifted(val, d, axis):
        """roll, with wrapped-in border cells marked invalid (roll alone
        would read the opposite map edge as a neighbour)."""
        v = torch.roll(val, d, axis)
        o = torch.roll(ok, d, axis)
        idx = torch.arange(val.shape[axis], device=val.device)
        inb = (idx >= d) if d > 0 else (idx < val.shape[axis] + d)
        inb = inb.unsqueeze(1 - axis)
        return v, o & inb

    vp, op_ = shifted(filled, -1, 0)
    vm, om = shifted(filled, 1, 0)
    dzdx = (torch.where(op_, vp, filled) - torch.where(om, vm, filled)) / (2 * res)
    vp, op_ = shifted(filled, -1, 1)
    vm, om = shifted(filled, 1, 1)
    dzdy = (torch.where(op_, vp, filled) - torch.where(om, vm, filled)) / (2 * res)
    n = torch.stack([-dzdx, -dzdy, torch.ones_like(dzdx)], dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    slope = torch.arccos(torch.clamp(n[..., 2], -1.0, 1.0))
    nanm = ~ok
    return (torch.where(nanm[..., None], torch.full_like(n, float("nan")), n),
            torch.where(nanm, torch.full_like(slope, float("nan")), slope))


def signed_distance_2d(occupied: torch.Tensor, resolution) -> torch.Tensor:
    """2D signed distance to the occupied-cell set, metres (positive
    outside, negative inside): grid_map_sdf's per-layer 2D distance field.
    Jump flooding over rolled seed maps, log2 passes of a 9-neighbour min
    and one cleanup pass: exact for convex regions, within one cell
    elsewhere."""
    H, W = occupied.shape
    dev = occupied.device
    ii, jj = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    big = 1e9
    inf = torch.full_like(ii, float("inf"))

    def edt(seed_mask):
        si = torch.where(seed_mask, ii, torch.full_like(ii, big))
        sj = torch.where(seed_mask, jj, torch.full_like(jj, big))

        def pass_at(step, si, sj):
            best_d = torch.where(si < big, (si - ii) ** 2 + (sj - jj) ** 2, inf)
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    if di == 0 and dj == 0:
                        continue
                    ci = torch.roll(si, (di * step, dj * step), (0, 1))
                    cj = torch.roll(sj, (di * step, dj * step), (0, 1))
                    d = torch.where(ci < big, (ci - ii) ** 2 + (cj - jj) ** 2,
                                    inf)
                    take = d < best_d
                    si = torch.where(take, ci, si)
                    sj = torch.where(take, cj, sj)
                    best_d = torch.where(take, d, best_d)
            return si, sj

        n_pass = max(H, W).bit_length()
        for p in range(n_pass):
            si, sj = pass_at(1 << (n_pass - 1 - p), si, sj)
        si, sj = pass_at(1, si, sj)         # the standard JFA+1 cleanup pass
        d2 = torch.where(si < big, (si - ii) ** 2 + (sj - jj) ** 2, inf)
        return torch.sqrt(d2)

    occupied = occupied.to(torch.bool)
    d_out = edt(occupied)                 # distance to the nearest occupied
    d_in = edt(~occupied)                 # distance to the nearest free
    res = torch.as_tensor(resolution, dtype=torch.float32, device=dev)
    return torch.where(occupied, -d_in, d_out) * res


def obstacle_sdf(hm: HeightMap, reference_z, clearance: float = 0.3) -> torch.Tensor:
    """Signed distance (m) to cells whose elevation rises more than
    `clearance` above `reference_z` (the vehicle footprint's z).  Empty
    cells count as free space."""
    e = hm.elevation
    occ = ~torch.isnan(e) & (e > reference_z + clearance)
    return signed_distance_2d(occ, hm.resolution)
