"""Relocalization in a previously built map (port of
`lio_slam_tpu/pipeline/relocalization.py`).

The reference intends it and never implements it (`common_lib::remapping`
returns -1, `lib/common_lib.cpp:38-43`; "TODO remapping",
`mapOptmization.cpp:443-447`).  Here:

1. place recognition: the query scan's Scan Context descriptor against the
   map's keyframe descriptors (`ops/scancontext.detect`, the whole DB);
2. pose refinement: point-to-plane registration of the query scan against
   the submap around the matched keyframe (`registration.register`, the
   fused kernel on CUDA tensors), starting from the matched yaw.

The JAX version's `lax.cond` on the match is one host branch here (one
device-to-host read).  Typical use: `checkpoint.load_checkpoint`, then
`relocalize` a fresh scan, then seed a new mission at the returned pose.
In a sharded mission pass `runner.global_state()` (the keyframe clouds
gathered from every rank), not a rank's `runner.state`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lio_slam_tpu_torch.config import Config
from lio_slam_tpu_torch.ops import registration as reg
from lio_slam_tpu_torch.ops import scancontext as sc
from lio_slam_tpu_torch.pipeline import lio as lio_mod
from lio_slam_tpu_torch.pipeline.loop_closure import _submap_around
from lio_slam_tpu_torch.utils import pointcloud as pc
from lio_slam_tpu_torch.utils import se3


class RelocResult(NamedTuple):
    success: torch.Tensor      # () bool
    pose: torch.Tensor         # (6,) pose in the map frame (valid on success)
    matched_kf: torch.Tensor   # () int32 keyframe index (-1 if none)
    sc_distance: torch.Tensor  # () descriptor distance
    fitness: torch.Tensor      # () registration mean residual


def make_relocalizer(cfg: Config):
    l = cfg.loop
    s = cfg.static

    def relocalize(state: lio_mod.LioState, scan: pc.Cloud) -> RelocResult:
        """The pose of a body-frame `scan` within `state`'s map."""
        scan_ds = pc.voxel_downsample(scan, cfg.registration.mapping_surf_leaf_size,
                                      s.max_scan_points)
        desc = sc.make_descriptor(
            scan_ds.xyz, scan_ds.mask, max_radius=l.sc_max_radius,
            lidar_height=l.sc_lidar_height, num_ring=s.sc_num_ring,
            num_sector=s.sc_num_sector)
        # relocalization queries the whole DB: no recency exclusion
        match = sc.detect(state.sc_db, desc, dist_threshold=l.sc_dist_thresh,
                          num_candidates=s.sc_candidates, exclude_recent=0)
        dev = scan_ds.xyz.device
        if int(match.index) < 0:                   # host branch (JAX lax.cond)
            return RelocResult(
                success=torch.zeros((), dtype=torch.bool, device=dev),
                pose=torch.zeros(6, dtype=torch.float32, device=dev),
                matched_kf=match.index, sc_distance=match.distance,
                fitness=torch.zeros((), dtype=torch.float32, device=dev))
        kf_idx = match.index.to(torch.int64)
        yaw = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0, 0.0], device=dev) * match.yaw
        init = se3.pose6_compose(state.store.poses[kf_idx], yaw)
        submap = _submap_around(state.store, kf_idx, l.search_num,
                                s.icp_submap_points,
                                cfg.registration.mapping_surf_leaf_size)
        r = reg.register(scan_ds.xyz, scan_ds.mask, submap.xyz, submap.mask,
                         init, cfg.registration)
        # acceptance: fitness and the inlier FRACTION (a false basin can
        # have a low residual on few inliers).  The strict `converged` flag
        # may stay false on a good alignment that used every iteration
        n_scan = torch.clamp(torch.sum(scan_ds.mask.to(torch.int32)), min=1)
        frac = r.num_inliers.to(torch.float32) / n_scan.to(torch.float32)
        ok = (r.mean_residual < l.fitness_score) & (frac > 0.3)
        return RelocResult(success=ok, pose=r.pose, matched_kf=match.index,
                           sc_distance=match.distance, fitness=r.mean_residual)

    return relocalize
