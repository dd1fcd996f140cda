"""Keyframe tensor store (port of `lio_slam_tpu/pipeline/keyframes.py`,
mapOptmization.cpp:74-86 and the keyframe gate :1909-1928).

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
                 stamp: torch.Tensor, cloud: pc.Cloud) -> KeyframeStore:
    """Append at slot `count` (the step evicts first at capacity; the clamp
    only protects direct callers)."""
    K = store.poses.shape[0]
    P = store.clouds.shape[1]
    i = torch.clamp(store.count, max=K - 1).to(torch.int64)
    poses, stamps = store.poses.clone(), store.stamps.clone()
    clouds, masks = store.clouds.clone(), store.cloud_masks.clone()
    poses[i] = pose
    stamps[i] = stamp
    clouds[i] = cloud.xyz[:P]
    masks[i] = cloud.mask[:P]
    return store._replace(poses=poses, stamps=stamps, clouds=clouds,
                          cloud_masks=masks,
                          count=torch.clamp(store.count + 1, max=K))


def transform_keyframe_clouds(store: KeyframeStore) -> torch.Tensor:
    """All keyframe clouds in world frame (K, P, 3)."""
    R, t = se3.pose6_to_Rt(store.poses)
    return torch.einsum("kij,kpj->kpi", R, store.clouds) + t[:, None, :]
