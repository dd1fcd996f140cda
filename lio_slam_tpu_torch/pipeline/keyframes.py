"""Keyframe tensor store and local-map assembly (port of
`lio_slam_tpu/pipeline/keyframes.py`, mapOptmization.cpp:74-86, the
keyframe gate :1909-1928, and extractNearby / extractCloud :1519-1588 for
the rebuild-mode map and the LOAM corner map).

Updates are functional: a new store shares no storage that a later update
writes, so a caller may keep an old state (the tests carry states across
implementations this way).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lio_slam_tpu_torch.utils import pointcloud as pc
from lio_slam_tpu_torch.utils import se3


class KeyframeStore(NamedTuple):
    poses: torch.Tensor         # (K, 6) optimized keyframe poses
    stamps: torch.Tensor        # (K,) scan timestamps (seconds)
    clouds: torch.Tensor        # (K, P, 3) downsampled clouds in body frame
    cloud_masks: torch.Tensor   # (K, P) bool
    count: torch.Tensor         # () int32 number of active keyframes
    corner_clouds: torch.Tensor  # (K, Pc, 3) LOAM corners (Pc = 1 when off)
    corner_masks: torch.Tensor   # (K, Pc) bool


def empty_store(max_keyframes: int, points_per_kf: int,
                corner_points_per_kf: int = 1, device=None) -> KeyframeStore:
    K, P = max_keyframes, points_per_kf
    Pc = max(corner_points_per_kf, 1)
    f32 = dict(dtype=torch.float32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return KeyframeStore(
        poses=torch.zeros((K, 6), **f32), stamps=torch.zeros(K, **f32),
        clouds=torch.zeros((K, P, 3), **f32),
        cloud_masks=torch.zeros((K, P), **b),
        count=torch.zeros((), dtype=torch.int32, device=device),
        corner_clouds=torch.zeros((K, Pc, 3), **f32),
        corner_masks=torch.zeros((K, Pc), **b))


def should_add_keyframe(store: KeyframeStore, pose: torch.Tensor,
                        angle_threshold: float,
                        dist_threshold: float) -> torch.Tensor:
    """saveFrame gate: the first scan always; else motion since the last
    keyframe beyond either threshold."""
    last = store.poses[torch.clamp(store.count - 1, min=0).to(torch.int64)]
    delta = se3.pose6_between(last, pose)
    big_angle = torch.any(torch.abs(delta[:3]) >= angle_threshold)
    big_dist = torch.linalg.norm(delta[3:]) >= dist_threshold
    return (store.count == 0) | big_angle | big_dist


def add_keyframe(store: KeyframeStore, pose: torch.Tensor,
                 stamp: torch.Tensor, cloud: pc.Cloud,
                 corner: pc.Cloud = None) -> KeyframeStore:
    """Append at slot `count` (the step evicts first at capacity; the clamp
    only protects direct callers), with the keyframe's LOAM corners when
    given."""
    K = store.poses.shape[0]
    P = store.clouds.shape[1]
    i = torch.clamp(store.count, max=K - 1).to(torch.int64)
    poses, stamps = store.poses.clone(), store.stamps.clone()
    clouds, masks = store.clouds.clone(), store.cloud_masks.clone()
    poses[i] = pose
    stamps[i] = stamp
    clouds[i] = cloud.xyz[:P]
    masks[i] = cloud.mask[:P]
    store = store._replace(poses=poses, stamps=stamps, clouds=clouds,
                           cloud_masks=masks,
                           count=torch.clamp(store.count + 1, max=K))
    if corner is not None:
        Pc = store.corner_clouds.shape[1]
        cc, cm = store.corner_clouds.clone(), store.corner_masks.clone()
        cc[i] = corner.xyz[:Pc]
        cm[i] = corner.mask[:Pc]
        store = store._replace(corner_clouds=cc, corner_masks=cm)
    return store


def keyframe_rows(store: KeyframeStore, idx: torch.Tensor):
    """(clouds (n, P, 3), masks (n, P)) of the keyframes at `idx` (n,): the
    single-device reader of `MapOps.keyframe_rows`."""
    return store.clouds[idx], store.cloud_masks[idx]


def _select_nearby(store: KeyframeStore, position: torch.Tensor,
                   now: torch.Tensor, radius: float, recent_sec: float,
                   max_selected: int):
    """extractNearby's keyframe selection: within `radius` of `position` or
    of the last `recent_sec` seconds; the `max_selected` nearest win (a
    stable order, so equal distances keep the lower slot first)."""
    K = store.poses.shape[0]
    kf_mask = torch.arange(K, device=position.device) < store.count
    d2 = torch.sum((store.poses[:, 3:] - position[None, :]) ** 2, dim=-1)
    recent = store.stamps >= (now - recent_sec)
    selected = kf_mask & ((d2 <= radius * radius) | recent)
    order_key = torch.where(selected, d2, torch.full_like(d2, float("inf")))
    sel_idx = torch.argsort(order_key, stable=True)[:max_selected]
    return sel_idx, torch.isfinite(order_key[sel_idx])


def _merge_selected(store: KeyframeStore, clouds: torch.Tensor,
                    masks: torch.Tensor, sel_idx: torch.Tensor,
                    sel_valid: torch.Tensor, leaf_size: float,
                    map_capacity: int) -> pc.Cloud:
    """The selected keyframes' clouds in map frame, merged and voxel
    downsampled into a fixed-capacity cloud (extractCloud)."""
    R, t = se3.pose6_to_Rt(store.poses[sel_idx])
    sel_masks = masks[sel_idx] & sel_valid[:, None]
    world = torch.einsum("sij,spj->spi", R, clouds[sel_idx]) + t[:, None, :]
    merged = pc.Cloud(xyz=world.reshape(-1, 3), mask=sel_masks.reshape(-1))
    return pc.voxel_downsample(merged, leaf_size, map_capacity)


def assemble_local_map(store: KeyframeStore, position: torch.Tensor,
                       now: torch.Tensor, radius: float, recent_sec: float,
                       leaf_size: float, max_selected: int,
                       map_capacity: int) -> pc.Cloud:
    """extractNearby + extractCloud: the keyframes within `radius` of
    `position` and those of the last `recent_sec` seconds, the
    `max_selected` nearest of them, their clouds in map frame merged and
    voxel downsampled into `map_capacity` points (the rebuild-mode map)."""
    sel_idx, sel_valid = _select_nearby(store, position, now, radius,
                                        recent_sec, max_selected)
    return _merge_selected(store, store.clouds, store.cloud_masks,
                           sel_idx, sel_valid, leaf_size, map_capacity)


def assemble_corner_map(store: KeyframeStore, position: torch.Tensor,
                        now: torch.Tensor, radius: float, recent_sec: float,
                        leaf_size: float, max_selected: int,
                        map_capacity: int) -> pc.Cloud:
    """The corner local map (upstream LIO-SAM's laserCloudCornerFromMap):
    the surface map's keyframe selection over the keyframes' corner
    clouds."""
    sel_idx, sel_valid = _select_nearby(store, position, now, radius,
                                        recent_sec, max_selected)
    return _merge_selected(store, store.corner_clouds, store.corner_masks,
                           sel_idx, sel_valid, leaf_size, map_capacity)


def transform_keyframe_clouds(store: KeyframeStore) -> torch.Tensor:
    """All keyframe clouds in world frame (K, P, 3)."""
    R, t = se3.pose6_to_Rt(store.poses)
    return torch.einsum("kij,kpj->kpi", R, store.clouds) + t[:, None, :]
