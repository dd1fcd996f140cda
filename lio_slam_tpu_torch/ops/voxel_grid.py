"""Spatial hash-grid neighbour search (port of `lio_slam_tpu/ops/voxel_grid.py`).

Points live in a bucket-major (T buckets x C slots x 3) table; empty slots
hold SENTINEL coordinates so a query needs no occupancy read.  The halo
layout (config.py `grid_halo`) trades insert rows a point against buckets
a query scans:

- "none": each point inserted once; a query scans the 27 surrounding cells
  (also the map products' outlier removal).
- "z" (the default): each point inserted under its own cell and its z±1
  cells; a query scans the 9 xy-neighbour cells.
- "xy": each point inserted under its 9 xy-neighbour cells; a query scans
  its own cell and z±1 (3 buckets, a bucket cap about 3x "z"'s).
- "full": each point inserted under all 27 neighbour cells; a query reads
  its own bucket alone (`gather_candidates`).

Offsets are listed in the JAX package's order (`jnp.meshgrid(...,
indexing="ij")`, the z offsets as written there): a query's rows follow
them, and that order decides the neighbour a tie goes to.  Any other
layout name raises ValueError.

Bucket ids must equal the JAX package's bit for bit: the int32 hash wraps
on overflow in both (torch's int32 multiply wraps like jnp's), `abs` of
INT_MIN stays INT_MIN, and `%` is the floor-mod of both frameworks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lio_slam_tpu_torch.utils.resident import constant

SENTINEL = 1e6           # empty-slot coordinate; d2 >= ~1e12 >> any real match
_BIG = 1e30
_VALID_MAX = 1e10        # d2 above this means "sentinel / no neighbour"

_HASH = (73856093, 19349663, 83492791)
_OFFSETS_Z3 = ((0, 0, 0), (0, 0, -1), (0, 0, 1))
_OFFSETS_XY9 = tuple((i, j, 0) for i in (-1, 0, 1) for j in (-1, 0, 1))
_OFFSETS_27 = tuple((i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                    for k in (-1, 0, 1))
_OFFSETS_1 = ((0, 0, 0),)
# insert multiplicity / cells a query scans, per layout
_INSERT_OFFSETS = {"none": _OFFSETS_1, "z": _OFFSETS_Z3, "xy": _OFFSETS_XY9,
                   "full": _OFFSETS_27}
_QUERY_OFFSETS = {"none": _OFFSETS_27, "z": _OFFSETS_XY9, "xy": _OFFSETS_Z3,
                  "full": _OFFSETS_1}


class HashGrid(NamedTuple):
    """Bucket-major point table; T, C come from the table's shape."""

    table: torch.Tensor      # (T, C, 3) float32 points (SENTINEL where empty)
    counts: torch.Tensor     # (T,) int32 inserted slots per bucket (capped C)
    cell_size: torch.Tensor  # () float32


class NeighborResult(NamedTuple):
    neighbors: torch.Tensor  # (N, k, 3) coordinates
    dist2: torch.Tensor      # (N, k)
    valid: torch.Tensor      # (N, k)


def _check_halo(halo: str):
    if halo not in _QUERY_OFFSETS:
        raise ValueError(f"grid_halo={halo!r}: the layouts are "
                         f"{sorted(_QUERY_OFFSETS)}")


def insert_offsets(device, halo: str = "z") -> torch.Tensor:
    _check_halo(halo)
    return constant(_INSERT_OFFSETS[halo], torch.int32, device)


def query_offsets(device, halo: str = "z") -> torch.Tensor:
    _check_halo(halo)
    return constant(_QUERY_OFFSETS[halo], torch.int32, device)


def _cell_hash(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """int32 cell coords (..., 3) -> bucket id in [0, table_size)."""
    h = ((coords[..., 0] * _HASH[0]) ^ (coords[..., 1] * _HASH[1])
         ^ (coords[..., 2] * _HASH[2]))
    return torch.abs(h) % table_size


def bucket_ids(points: torch.Tensor, cell_size: torch.Tensor,
               table_size: int, halo: str = "z") -> torch.Tensor:
    """(O, N) int32 ids of the buckets a query scans, offset-major — the
    `hh` of `fused_corr.gather_planar`."""
    coords = torch.floor(points / cell_size).to(torch.int32)        # (N, 3)
    cells = coords[None, :, :] + query_offsets(points.device, halo)[:, None, :]
    return _cell_hash(cells, table_size)


def empty_grid(cell_size: float, table_size: int = 32768,
               max_per_cell: int = 16, dtype=torch.float32,
               device=None) -> HashGrid:
    return HashGrid(
        table=torch.full((table_size, max_per_cell, 3), SENTINEL, dtype=dtype,
                         device=device),
        counts=torch.zeros(table_size, dtype=torch.int32, device=device),
        # a fill, not a copy from the host: `build_grid` runs inside the
        # captured resident step on the rebuild-mode map
        cell_size=torch.full((), cell_size, dtype=torch.float32,
                             device=device))


def _insert_core(table: torch.Tensor, counts: torch.Tensor,
                 points: torch.Tensor, mask: torch.Tensor,
                 cell_size: torch.Tensor, halo: str):
    """Emit K halo rows per point, stable-sort all rows by target bucket,
    rank within runs, scatter into ring slots (the JAX `_insert_core`)."""
    T, C, _ = table.shape
    dev = points.device
    offsets = insert_offsets(dev, halo)
    K = offsets.shape[0]
    M = points.shape[0]
    coords = torch.floor(points / cell_size).to(torch.int32)        # (M, 3)
    h = _cell_hash(coords[:, None, :] + offsets[None], T)           # (M, K)
    # offset cells of one point may hash-collide; keep the first only
    ar = torch.arange(K, device=dev)
    dup = torch.any((h[:, :, None] == h[:, None, :])
                    & (ar[None, :, None] > ar[None, None, :]), dim=2)
    keep_row = mask[:, None] & ~dup
    hf = torch.where(keep_row, h, torch.full_like(h, T)).reshape(-1)
    pts = points[:, None, :].expand(M, K, 3).reshape(-1, 3)
    h_s, order = torch.sort(hf, stable=True)
    pts_s = pts[order]
    first = torch.ones_like(h_s, dtype=torch.bool)
    first[1:] = h_s[1:] != h_s[:-1]
    pos = torch.arange(h_s.shape[0], dtype=torch.int32, device=dev)
    run_start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)),
                             dim=0).values
    rank = pos - run_start
    live = h_s < T
    ok = live & (rank < C)                        # at most C new per bucket
    base = torch.where(live, counts[torch.clamp(h_s, max=T - 1).to(torch.int64)],
                       torch.zeros_like(h_s))
    slot = (base + rank) % C                      # ring overwrite on overflow
    dst_b = torch.where(ok, h_s, torch.full_like(h_s, T)).to(torch.int64)
    dst_s = torch.where(ok, slot, torch.zeros_like(slot)).to(torch.int64)
    padded = torch.cat([table, torch.full((1, C, 3), SENTINEL, dtype=table.dtype,
                                          device=dev)], dim=0)
    padded[dst_b, dst_s] = pts_s                  # only the dump row repeats
    new = torch.zeros(T + 1, dtype=torch.int32, device=dev).index_add_(
        0, dst_b, ok.to(torch.int32))
    counts = torch.clamp(counts + new[:T], max=C)
    return padded[:T], counts


def build_grid(points: torch.Tensor, mask: torch.Tensor, cell_size: float,
               table_size: int = 32768, max_per_cell: int = 16,
               halo: str = "z", chunk: int = 262144) -> HashGrid:
    """Build a grid over `points`, inserting `chunk` points at a time."""
    grid = empty_grid(cell_size, table_size, max_per_cell, points.dtype,
                      points.device)
    table, counts = grid.table, grid.counts
    for s in range(0, points.shape[0], chunk):
        table, counts = _insert_core(table, counts, points[s:s + chunk],
                                     mask[s:s + chunk], grid.cell_size, halo)
    return HashGrid(table=table, counts=counts, cell_size=grid.cell_size)


def insert_points(grid: HashGrid, points: torch.Tensor, mask: torch.Tensor,
                  halo: str = "z") -> HashGrid:
    """Incrementally insert points (a new keyframe cloud) into the grid."""
    table, counts = _insert_core(grid.table, grid.counts, points, mask,
                                 grid.cell_size, halo)
    return HashGrid(table=table, counts=counts, cell_size=grid.cell_size)


def gather_candidates(grid: HashGrid, queries: torch.Tensor) -> torch.Tensor:
    """The "full" layout's single-bucket candidate fetch, planar as the JAX
    package's: (3C, N) with rows [x_0..x_{C-1}, y_*, z_*]."""
    T, C, _ = grid.table.shape
    coords = torch.floor(queries / grid.cell_size).to(torch.int32)
    hh = _cell_hash(coords, T).to(torch.int64)                      # (N,)
    return grid.table[hh].permute(2, 1, 0).reshape(3 * C, queries.shape[0])


def query_knn(grid: HashGrid, queries: torch.Tensor, query_mask: torch.Tensor,
              k: int = 5, halo: str = "z") -> NeighborResult:
    """Exact k-NN among the candidates of the buckets a query scans under
    `halo` (27 for "none", 9 for "z", 3 for "xy", its own for "full").

    Iterative masked argmin over the R = O*C candidate rows; ties go to the
    lowest row, as `jnp.argmin` breaks them."""
    T, C, _ = grid.table.shape
    N = queries.shape[0]
    hh = bucket_ids(queries, grid.cell_size, T, halo)                # (O, N)
    O = hh.shape[0]
    R = O * C
    cand = grid.table[hh.to(torch.int64)]                            # (O, N, C, 3)
    cand = cand.permute(0, 2, 1, 3).reshape(R, N, 3)                 # row o*C + c
    d2 = ((cand[..., 0] - queries[:, 0]) ** 2 + (cand[..., 1] - queries[:, 1]) ** 2
          + (cand[..., 2] - queries[:, 2]) ** 2)                     # (R, N)
    ar = torch.arange(O, device=queries.device)
    dup = torch.any((hh[:, None, :] == hh[None, :, :])
                    & (ar[:, None, None] > ar[None, :, None]), dim=1)  # (O, N)
    d2 = torch.where(dup.repeat_interleave(C, dim=0),
                     torch.full_like(d2, _BIG), d2)
    nbs, dsts = [], []
    dd = d2
    cols = torch.arange(N, device=queries.device)
    for _ in range(k):
        am = torch.argmin(dd, dim=0)
        nbs.append(cand[am, cols])
        dsts.append(dd[am, cols])
        dd = dd.clone()
        dd[am, cols] = _BIG
    neighbors = torch.stack(nbs, dim=1)                              # (N, k, 3)
    best_d = torch.stack(dsts, dim=1)
    valid = (best_d < _VALID_MAX) & query_mask[:, None]
    return NeighborResult(
        neighbors=neighbors,
        dist2=torch.where(valid, torch.clamp(best_d, min=0.0),
                          torch.full_like(best_d, _BIG)),
        valid=valid)
