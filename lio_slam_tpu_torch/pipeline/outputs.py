"""Map products (port of `lio_slam_tpu/pipeline/outputs.py`): the rolling
local planning map, the global map export and the height map.

- `publishLocalMap` (`mapOptmization.cpp:2442-2552`): the last N keyframe
  clouds, cropped to a yaw-aligned box around the vehicle (:2502-2506),
  voxel downsampled, statistical outlier removal -> `map_4planning`.
- `saveMapService` (:918-971): trajectory, transformations and global map
  PCDs (the service, and the shutdown save when savePCD is set).
- the grid_map height-map node (`ops/heightmap.py`) rasterizes the
  planning map.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from lio_slam_tpu_torch.config import Config
from lio_slam_tpu_torch.io import pcd as pcd_io
from lio_slam_tpu_torch.ops import heightmap as hm
from lio_slam_tpu_torch.ops import voxel_grid as vg
from lio_slam_tpu_torch.pipeline import keyframes as kfm
from lio_slam_tpu_torch.utils import pointcloud as pc
from lio_slam_tpu_torch.utils import se3


def statistical_outlier_mask(xyz: torch.Tensor, mask: torch.Tensor,
                             mean_k: int = 5, stddev_mul: float = 1.0,
                             cell: float = 2.0, table: int = 8192) -> torch.Tensor:
    """pcl::StatisticalOutlierRemoval: each point's mean distance to its k
    neighbours; drop points whose mean exceeds the global mean +
    stddev_mul * std.  The neighbours come from a halo "none" grid (one
    insert a point, 27 cells a query), as in the JAX package."""
    grid = vg.build_grid(xyz, mask, cell, table, 32, halo="none")
    nn = vg.query_knn(grid, xyz, mask, k=mean_k + 1, halo="none")  # +1: self
    d = torch.sqrt(torch.clamp(nn.dist2, min=0.0))
    d = torch.where(nn.valid, d, torch.zeros_like(d))
    n_nb = torch.sum(nn.valid, dim=1)
    mean_d = torch.sum(d, dim=1) / torch.clamp(n_nb - 1, min=1)   # self: 0
    # a point without k neighbours within the grid radius is isolated: PCL's
    # kd-tree would report huge distances for it; drop it outright
    valid = mask & (n_nb >= mean_k + 1)
    n_valid = torch.clamp(torch.sum(valid), min=1)
    zero = torch.zeros_like(mean_d)
    mu = torch.sum(torch.where(valid, mean_d, zero)) / n_valid
    var = torch.sum(torch.where(valid, (mean_d - mu) ** 2, zero)) / n_valid
    return valid & (mean_d <= mu + stddev_mul * torch.sqrt(var))


def make_local_map_fn(cfg: Config):
    """(local_planning_map(store, pose6) -> Cloud,
    height_map(planning_cloud, pose6) -> HeightMap)."""
    o = cfg.output
    s = cfg.static

    def local_planning_map(store: kfm.KeyframeStore,
                           pose6: torch.Tensor) -> pc.Cloud:
        """The map_4planning product around the current pose."""
        K = store.poses.shape[0]
        dev = store.poses.device
        # the last N keyframes (publishLocalMap takes the most recent)
        idx0 = torch.clamp(store.count - o.local_map_keyframes, min=0)
        take_idx = torch.clamp(
            idx0 + torch.arange(o.local_map_keyframes, device=dev), 0, K - 1)
        valid_kf = take_idx < store.count
        take_idx = take_idx.to(torch.int64)
        masks = store.cloud_masks[take_idx] & valid_kf[:, None]
        R, t = se3.pose6_to_Rt(store.poses[take_idx])
        world = torch.einsum("sij,spj->spi", R, store.clouds[take_idx]) \
            + t[:, None, :]
        flat = world.reshape(-1, 3)
        fmask = masks.reshape(-1)
        # yaw-aligned box crop about the vehicle (:2502-2506)
        yaw = pose6[2]
        c, sn = torch.cos(-yaw), torch.sin(-yaw)
        rel = flat[:, :2] - pose6[3:5][None, :]
        xr = rel[:, 0] * c - rel[:, 1] * sn
        yr = rel[:, 0] * sn + rel[:, 1] * c
        bx, by = o.local_map_box
        fmask = fmask & (torch.abs(xr) <= bx) & (torch.abs(yr) <= by)
        ds = pc.voxel_downsample(pc.Cloud(xyz=flat, mask=fmask),
                                 o.global_map_leaf_size, s.max_map_points)
        sor = statistical_outlier_mask(ds.xyz, ds.mask, o.sor_mean_k,
                                       o.sor_stddev)
        return ds._replace(mask=sor)

    def height_map(planning_cloud: pc.Cloud, pose6: torch.Tensor) -> hm.HeightMap:
        return hm.rasterize(planning_cloud.xyz, planning_cloud.mask,
                            pose6[3:5], o.heightmap_resolution,
                            tuple(o.heightmap_size))

    return local_planning_map, height_map


class SaveMapResult(NamedTuple):
    success: bool
    num_points: int
    files: list


def save_map(store: kfm.KeyframeStore, destination: str,
             resolution: float = 0.0) -> SaveMapResult:
    """saveMapService (:918-971): write the trajectory, the keyframe
    transformations and the global map as PCDs.  `resolution > 0` voxel
    downsamples the global map first."""
    n_kf = int(store.count)
    if n_kf == 0:
        return SaveMapResult(success=False, num_points=0, files=[])
    os.makedirs(destination, exist_ok=True)
    host = lambda x: x.detach().cpu().numpy()
    poses = host(store.poses[:n_kf])
    files = []
    # trajectory.pcd: keyframe positions (intensity = keyframe index)
    traj_path = os.path.join(destination, "trajectory.pcd")
    pcd_io.save_pcd(traj_path, poses[:, 3:6], intensity=np.arange(n_kf))
    files.append(traj_path)
    # transformations.pcd: 6-DoF keyframe poses as PointTypePose rows
    # (x/y/z/intensity=index/roll/pitch/yaw/time, cloudKeyPoses6D,
    # mapOptmization.cpp:928-932); the npz is for array consumers
    tf_path = os.path.join(destination, "transformations.pcd")
    stamps = host(store.stamps[:n_kf]).astype(np.float32)
    pcd_io.save_pcd(tf_path, poses[:, 3:6], intensity=np.arange(n_kf),
                    extra_fields={"roll": poses[:, 0], "pitch": poses[:, 1],
                                  "yaw": poses[:, 2], "time": stamps})
    np.savez(os.path.join(destination, "transformations.npz"), poses=poses)
    files.append(tf_path)
    # the global map: every keyframe cloud in the world frame, on the device
    world = kfm.transform_keyframe_clouds(store)[:n_kf]
    pts = world[store.cloud_masks[:n_kf]]
    if resolution > 0:
        cloud = pc.pad_cloud(pts, int(2 ** np.ceil(np.log2(max(len(pts), 2)))))
        ds = pc.voxel_downsample(cloud, resolution, cloud.capacity)
        pts = ds.xyz[ds.mask]
    pts = host(pts)
    # SurfMap.pcd: the surf-feature map (:950-952).  The liorf pipeline is
    # surf-only, so the surf map is the global map; both files are written
    # for downstream tools
    sm_path = os.path.join(destination, "SurfMap.pcd")
    pcd_io.save_pcd(sm_path, pts)
    files.append(sm_path)
    gm_path = os.path.join(destination, "GlobalMap.pcd")
    pcd_io.save_pcd(gm_path, pts)
    files.append(gm_path)
    return SaveMapResult(success=True, num_points=len(pts), files=files)
