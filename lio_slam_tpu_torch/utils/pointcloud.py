"""Masked fixed-capacity point tensors + voxel downsampling (port of
`lio_slam_tpu/utils/pointcloud.py`).

Every cloud is a `(capacity, 3)` float32 tensor plus a `(capacity,)` bool
mask.  The int32 voxel hashes wrap exactly like jnp's; sorts are stable,
like `jax.lax.sort`.  The segment sums are `index_add_`, which on CUDA adds
with atomics in no fixed order: centroids agree with the reference to float
rounding, masks exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_I32_MAX = 0x7FFFFFFF


class Cloud(NamedTuple):
    """Fixed-capacity masked point cloud (the JAX `Cloud` without the
    extra-channel `attr`, which nothing on the ported path carries).

    xyz:  (N, 3) float32; undefined where ~mask
    mask: (N,) bool
    """

    xyz: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def count(self) -> torch.Tensor:
        return torch.sum(self.mask).to(torch.int32)


def make_cloud(xyz, mask=None, device=None) -> Cloud:
    """A cloud of float32 points, every point valid unless `mask` says
    otherwise."""
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device=device)
    if mask is None:
        mask = torch.ones(xyz.shape[0], dtype=torch.bool, device=xyz.device)
    return Cloud(xyz=xyz, mask=torch.as_tensor(mask, dtype=torch.bool,
                                               device=xyz.device))


def pad_cloud(xyz, capacity: int, device=None) -> Cloud:
    """Pad a concrete (n, 3) array or tensor up to `capacity` with masked
    slots (points past `capacity` are dropped)."""
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device=device)
    n = min(xyz.shape[0], capacity)
    out = torch.zeros((capacity, 3), dtype=torch.float32, device=xyz.device)
    out[:n] = xyz[:n]
    mask = torch.arange(capacity, device=xyz.device) < n
    return Cloud(xyz=out, mask=mask)


def compact(cloud: Cloud) -> Cloud:
    """Move valid points to the front (stable). Same capacity."""
    order = torch.argsort((~cloud.mask).to(torch.int32), stable=True)
    return Cloud(xyz=cloud.xyz[order], mask=cloud.mask[order])


def filter_points(cloud: Cloud, min_range: float, max_range: float,
                  crop_min=None, crop_max=None) -> Cloud:
    """Range + self-crop-box gate (imageProjection.cpp:577-615).  The JAX
    version's intensity gate has no caller on the ported path."""
    r = torch.linalg.norm(cloud.xyz, dim=-1)
    keep = cloud.mask & (r >= min_range) & (r <= max_range)
    if crop_min is not None:
        cmin = torch.tensor(crop_min, dtype=torch.float32, device=cloud.xyz.device)
        cmax = torch.tensor(crop_max, dtype=torch.float32, device=cloud.xyz.device)
        inside = torch.all((cloud.xyz >= cmin) & (cloud.xyz <= cmax), dim=-1)
        keep = keep & ~inside
    return cloud._replace(mask=keep)


def decimate(cloud: Cloud, point_filter_num: int, ring=None,
             downsample_rate: int = 1) -> Cloud:
    """1-in-k point decimation + ring decimation (point_filter_num /
    downsampleRate)."""
    idx = torch.arange(cloud.capacity, device=cloud.xyz.device)
    keep = cloud.mask & (idx % point_filter_num == 0)
    if ring is not None and downsample_rate > 1:
        keep = keep & (ring.to(torch.int32) % downsample_rate == 0)
    return cloud._replace(mask=keep)


def _voxel_ids(xyz: torch.Tensor, mask: torch.Tensor,
               leaf: torch.Tensor) -> torch.Tensor:
    """Spatial-hash voxel id per point; invalid points get INT32_MAX."""
    coords = torch.floor(xyz / leaf).to(torch.int32)
    h = ((coords[..., 0] * 73856093) ^ (coords[..., 1] * 19349663)
         ^ (coords[..., 2] * 83492791))
    h = h & _I32_MAX
    return torch.where(mask, h, torch.full_like(h, _I32_MAX))


def _segment_centroids(keys_sorted: torch.Tensor, mask_s: torch.Tensor,
                       vals: torch.Tensor, max_out: int):
    """Run detection over sorted keys -> per-run means in the first
    `max_out` output slots.  The valid points are a prefix of the sorted
    order (masked points carry the largest key), so every run is a
    contiguous range: its sum is a difference of the float64 running sum at
    its two ends, and its count the distance between them.  Nothing is
    accumulated with atomics, so two runs give the same bits."""
    N = keys_sorted.shape[0]
    dev = vals.device
    first = torch.ones_like(mask_s)
    first[1:] = keys_sorted[1:] != keys_sorted[:-1]
    first = first & mask_s
    slot = torch.cumsum(first.to(torch.int64), 0) - 1
    # start position of each run; slot max_out takes the least start among
    # the runs past capacity (the end of run max_out - 1), slot max_out + 1
    # is where the points that start no run park
    park = torch.full_like(slot, max_out + 1)
    slot_c = torch.where(first, torch.clamp(slot, max=max_out), park)
    n_valid = torch.sum(mask_s.to(torch.int64))
    starts = torch.full((max_out + 2,), N, dtype=torch.int64, device=dev)
    starts.scatter_reduce_(0, slot_c, torch.arange(N, device=dev), "amin")
    starts = torch.minimum(starts, n_valid)
    lo, hi = starts[:max_out], starts[1:max_out + 1]
    # one row a column, scanned along the row: on CUDA a scan down the
    # columns of (N, C) is one thread a column, and a 1-D scan is the only
    # one whose order of sums is not fixed
    masked = torch.where(mask_s[:, None], vals, torch.zeros_like(vals))
    running = torch.cat([
        torch.zeros((vals.shape[1], 1), dtype=torch.float64, device=dev),
        torch.cumsum(masked.to(torch.float64).T.contiguous(), 1)], dim=1)
    counts = hi - lo
    sums = (running[:, hi] - running[:, lo]).T
    denom = torch.clamp(counts, min=1).to(torch.float64)
    return (sums / denom[:, None]).to(torch.float32).contiguous(), counts > 0


def voxel_downsample(cloud: Cloud, leaf_size: float, max_out: int) -> Cloud:
    """Centroid voxel-grid downsample (pcl::VoxelGrid) into a fixed-capacity
    output: sort by hashed voxel id -> run detection -> segment mean."""
    leaf = torch.tensor(leaf_size, dtype=torch.float32, device=cloud.xyz.device)
    vid = _voxel_ids(cloud.xyz, cloud.mask, leaf)
    vid_s, order = torch.sort(vid, stable=True)
    out, out_mask = _segment_centroids(vid_s, cloud.mask[order],
                                       cloud.xyz[order], max_out)
    return Cloud(xyz=out, mask=out_mask)


def packed_voxel_downsample(cloud: Cloud, leaf_size: float,
                            max_out: int) -> Cloud:
    """Exact centroid voxel downsample over exact 30-bit voxel ids — the
    scan path (`scan_downsample="packed"`).

    Voxel coords are recentred to the cloud's min corner and packed into 30
    bits (the working volume may span 1024 voxels per axis).  In-voxel
    offsets quantize to 16 bits per axis (leaf/65535), as in the JAX
    version, so the centroids are the same numbers; the sort carries a
    permutation instead of the TPU's packed payload lanes.
    """
    dev = cloud.xyz.device
    leaf = torch.tensor(leaf_size, dtype=torch.float32, device=dev)
    coords = torch.floor(cloud.xyz / leaf).to(torch.int32)            # (N, 3)
    big = torch.full_like(coords, 1 << 20)
    cmin = torch.min(torch.where(cloud.mask[:, None], coords, big), dim=0).values
    rel = coords - cmin
    valid = cloud.mask & torch.all(rel < 1024, dim=-1)
    vid = (rel[:, 0] << 20) | (rel[:, 1] << 10) | rel[:, 2]
    vid = torch.where(valid, vid, torch.full_like(vid, _I32_MAX))
    off = cloud.xyz - coords.to(torch.float32) * leaf
    q = torch.clamp(torch.round(off / leaf * 65535.0), 0, 65535).to(torch.int32)
    vid_s, order = torch.sort(vid, stable=True)
    mask_s = vid_s != _I32_MAX
    qs = q[order].to(torch.float32) * (1.0 / 65535.0)
    xyz_s = (coords[order].to(torch.float32) + qs) * leaf
    out, out_mask = _segment_centroids(vid_s, mask_s, xyz_s, max_out)
    return Cloud(xyz=out, mask=out_mask)


def merge_clouds(a: Cloud, b: Cloud, capacity: int) -> Cloud:
    """Concatenate two masked clouds into a fixed capacity (valid first)."""
    merged = compact(Cloud(xyz=torch.cat([a.xyz, b.xyz]),
                           mask=torch.cat([a.mask, b.mask])))
    return Cloud(xyz=merged.xyz[:capacity], mask=merged.mask[:capacity])


def random_downsample(cloud: Cloud, max_out: int) -> Cloud:
    """Stride subsample of the valid points to `max_out` (the fallback when
    a voxel grid is overkill).  Deterministic despite the name, as the JAX
    version is: its `key` argument is never read, so the port takes none."""
    c = compact(cloud)
    n = c.count().to(torch.int64)
    stride = torch.clamp(n // max_out + (n % max_out > 0).to(torch.int64),
                         min=1)
    pos = torch.arange(max_out, device=c.xyz.device) * stride
    idx = torch.clamp(pos, 0, c.capacity - 1)
    return Cloud(xyz=c.xyz[idx], mask=pos < n)
