"""Host-spill keyframe archive: never-forget loop memory (port of
`lio_slam_tpu/pipeline/archive.py`).

The reference's loop memory is unbounded: iSAM2 appends keyframes and
factors forever (`mapOptmization.cpp:2097-2134`) and Scan Context retrieval
covers the whole history (`Scancontext.cpp:253-296`).  The device store is
a fixed-capacity ring (`pipeline/lio.py:_evict_oldest`); without this tier
an evicted keyframe's cloud, descriptor and loop candidacy are gone.

- every keyframe's (pose, stamp, compacted cloud, SC descriptor) reaches
  the host through the runner's deferred fetch queue (`make_kf_snapshot`);
- the poses of still-live keyframes are refreshed on every drain, so the
  pose frozen at eviction is the last optimized one;
- retrieval runs over the evicted entries only (the live ones are the
  device detector's): a ring-key nearest-neighbour search and the all-shift
  cosine alignment of `ops/scancontext.py`, in numpy;
- on a match the archived submap goes back to the device and is verified
  by a registration through the fused kernel (`make_archive_verifier`),
  which queues a between factor to keyframe 0 and an absolute anchor.

`KeyframeArchive` and the helpers below it are a numpy copy of the JAX
module's host code.  Memory: about 4*3*points + 4*R*S bytes a keyframe,
unbounded by design, like the reference's keyframe history.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lio_slam_tpu_torch.config import Config
from lio_slam_tpu_torch.ops import registration as reg
from lio_slam_tpu_torch.pipeline import lio
from lio_slam_tpu_torch.utils import pointcloud as pc
from lio_slam_tpu_torch.utils import se3


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class KeyframeArchive:
    """Host-side append-only keyframe history, addressed by GLOBAL keyframe
    id (gid = device kf_count + evict_count - 1 at creation time — stable
    across evictions)."""

    def __init__(self, num_ring: int = 20, num_sector: int = 60,
                 base_gid: int = 0):
        self.num_ring = num_ring
        self.num_sector = num_sector
        # entry i holds gid base_gid + i; base_gid > 0 after a resume whose
        # checkpoint had no archive sidecar (pre-eviction history lost)
        self.base_gid = int(base_gid)
        self.poses: list[np.ndarray] = []       # (6,) f32, refreshed while live
        self.stamps: list[float] = []
        self.clouds: list[np.ndarray] = []      # (n_i, 3) compacted body-frame
        self.descriptors: list[np.ndarray] = [] # (R, S)
        self._ring_keys: list[np.ndarray] = []  # (R,)
        self.evict_count = 0                    # gids < this are device-evicted

    def __len__(self) -> int:
        return len(self.poses)

    @property
    def num_points(self) -> int:
        return sum(c.shape[0] for c in self.clouds)

    def add(self, gid: int, pose: np.ndarray, stamp: float,
            cloud: np.ndarray, descriptor: np.ndarray) -> None:
        """Append keyframe `gid` (must be len(self) — keyframes arrive in
        order through the drain stream)."""
        expected = self.base_gid + len(self.poses)
        if gid != expected:
            if gid < expected:
                return                           # duplicate drain — ignore
            raise ValueError(f"archive gap: expected gid {expected}, "
                             f"got {gid}")
        self.poses.append(np.asarray(pose, np.float32).copy())
        self.stamps.append(float(stamp))
        self.clouds.append(np.asarray(cloud, np.float32).copy())
        d = np.asarray(descriptor, np.float32).copy()
        self.descriptors.append(d)
        self._ring_keys.append(d.mean(axis=-1))

    def refresh_live_poses(self, evict_count: int, live_poses: np.ndarray,
                           live_count: int) -> None:
        """Sync archived copies of still-live keyframes with their current
        optimized estimates (so the pose frozen at eviction is the freshest
        one).  live_poses[i] is device slot i = gid evict_count + i."""
        self.evict_count = max(self.evict_count, int(evict_count))
        base = int(evict_count) - self.base_gid   # local index of slot 0
        for i in range(int(live_count)):
            li = base + i
            if 0 <= li < len(self.poses):
                self.poses[li] = np.asarray(live_poses[i], np.float32)

    # -- retrieval over the full (evicted) history ------------------------

    def match(self, now: float, time_diff: float, dist_thresh: float,
              num_candidates: int = 3) -> Optional[tuple]:
        """Scan Context retrieval of the NEWEST archived keyframe (the
        current one) against all EVICTED entries.  Returns
        (gid, yaw, distance) or None.  Pure numpy — the database is a
        (N, R) matrix; candidate alignment is 3 (R, S) images."""
        n = len(self.poses)
        n_evicted = self.evict_count - self.base_gid   # local evicted prefix
        if n < 2 or n_evicted <= 0:
            return None
        q_desc = self.descriptors[-1]
        q_key = self._ring_keys[-1]
        keys = np.stack(self._ring_keys[:n_evicted])             # (E, R)
        stamps = np.asarray(self.stamps[:n_evicted])
        # eligibility against the CURRENT scan time (`now`), matching the
        # reference's timeLaserInfoCur - candidate_time gate
        # (performSCLoopClosure, mapOptmization.cpp:1190-1199) — the runner
        # attempts the match after this scan's snapshot drains, so the query
        # descriptor is current too (round-4 advisor)
        elig = (now - stamps) > time_diff
        if not elig.any():
            return None
        d_ring = np.linalg.norm(keys - q_key[None, :], axis=-1)
        d_ring[~elig] = np.inf
        cand = np.argsort(d_ring)[:num_candidates]
        cand = cand[np.isfinite(d_ring[cand])]
        if cand.size == 0:
            return None
        cands = np.stack([self.descriptors[int(c)] for c in cand])
        dist = _sc_distance_all_shifts_np(q_desc, cands)         # (C, S)
        best_shift = dist.argmin(axis=-1)
        best_dist = dist.min(axis=-1)
        b = int(best_dist.argmin())
        if best_dist[b] >= dist_thresh:
            return None
        S = q_desc.shape[-1]
        # yaw sign convention matches ops/scancontext.detect
        yaw = -float(best_shift[b]) * (2.0 * np.pi / S)
        if yaw < -np.pi:
            yaw += 2 * np.pi
        return self.base_gid + int(cand[b]), yaw, float(best_dist[b])

    def submap(self, gid: int, search_num: int,
               max_points: int) -> np.ndarray:
        """World-frame merged cloud of archived keyframes
        [gid-search_num, gid+search_num] (loopFindNearKeyframes semantics,
        mapOptmization.cpp:1360-1383) using their archived poses; stride-
        decimated to `max_points`."""
        lo = max(gid - search_num - self.base_gid, 0)
        hi = min(gid + search_num + 1 - self.base_gid, len(self.poses))
        parts = []
        for i in range(lo, hi):
            R, t = _pose6_to_Rt_np(self.poses[i])
            parts.append(self.clouds[i] @ R.T + t[None, :])
        pts = np.concatenate(parts, axis=0) if parts else np.zeros((0, 3), np.float32)
        if pts.shape[0] > max_points:
            stride = int(np.ceil(pts.shape[0] / max_points))
            pts = pts[::stride][:max_points]
        return np.ascontiguousarray(pts, np.float32)

    @classmethod
    def from_state(cls, state) -> "KeyframeArchive":
        """Rebuild an archive from a restored LioState (resume path when the
        checkpoint has no archive sidecar): live keyframes are recoverable
        from the device store; pre-eviction history is gone, so base_gid
        starts at the state's eviction count."""
        count = int(state.store.count)
        evict = int(state.evict_count)
        descs = _host(state.sc_db.descriptors)
        a = cls(num_ring=descs.shape[1], num_sector=descs.shape[2],
                base_gid=evict)
        poses = _host(state.store.poses)
        stamps = _host(state.store.stamps)
        clouds = _host(state.store.clouds)
        masks = _host(state.store.cloud_masks)
        for i in range(count):
            a.add(evict + i, poses[i], float(stamps[i]),
                  clouds[i][masks[i]], descs[i])
        a.evict_count = evict
        return a

    # -- persistence (checkpoint sidecar) ---------------------------------

    def save(self, path: str) -> None:
        n = len(self.poses)
        offsets = np.zeros(n + 1, np.int64)
        for i, c in enumerate(self.clouds):
            offsets[i + 1] = offsets[i] + c.shape[0]
        pts = (np.concatenate(self.clouds, axis=0) if n
               else np.zeros((0, 3), np.float32))
        np.savez_compressed(
            path,
            poses=np.stack(self.poses) if n else np.zeros((0, 6), np.float32),
            stamps=np.asarray(self.stamps, np.float64),
            descriptors=(np.stack(self.descriptors) if n
                         else np.zeros((0, self.num_ring, self.num_sector),
                                       np.float32)),
            points=pts, offsets=offsets,
            evict_count=np.int64(self.evict_count),
            base_gid=np.int64(self.base_gid))

    @classmethod
    def load(cls, path: str) -> "KeyframeArchive":
        with np.load(path) as z:
            descs = z["descriptors"]
            base = int(z["base_gid"]) if "base_gid" in z else 0
            a = cls(num_ring=descs.shape[1] if descs.size else 20,
                    num_sector=descs.shape[2] if descs.size else 60,
                    base_gid=base)
            offsets = z["offsets"]
            pts = z["points"]
            for i in range(z["poses"].shape[0]):
                a.add(base + i, z["poses"][i], float(z["stamps"][i]),
                      pts[offsets[i]:offsets[i + 1]], descs[i])
            a.evict_count = int(z["evict_count"])
        return a


def _pose6_to_Rt_np(p: np.ndarray):
    """pose6 [r,p,y,x,y,z] -> (R, t), same conventions as utils/se3."""
    r, pch, y = float(p[0]), float(p[1]), float(p[2])
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(pch), np.sin(pch)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32), np.asarray(p[3:6], np.float32)


def compose_yaw_np(pose6: np.ndarray, yaw: float) -> np.ndarray:
    """pose6_compose(pose, [0,0,yaw,0,0,0]) on host (the SC yaw hypothesis
    for the ICP initial guess — loop_closure.py's sc_init, without an eager
    device round trip)."""
    R, t = _pose6_to_Rt_np(pose6)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], np.float32)
    Rn = R @ Rz
    rpy = np.array([np.arctan2(Rn[2, 1], Rn[2, 2]),
                    np.arcsin(np.clip(-Rn[2, 0], -1.0, 1.0)),
                    np.arctan2(Rn[1, 0], Rn[0, 0])], np.float32)
    return np.concatenate([rpy, t]).astype(np.float32)


def _sc_distance_all_shifts_np(query: np.ndarray, cands: np.ndarray):
    """Numpy port of ops.scancontext._sc_distance_all_shifts (same
    semantics: mean over valid columns of 1 - cosine)."""
    S = query.shape[-1]
    shifts = np.stack([np.roll(query, -s, axis=-1) for s in range(S)])
    qn = np.linalg.norm(shifts, axis=-2)                     # (S, S)
    cn = np.linalg.norm(cands, axis=-2)                      # (C, S)
    dots = np.einsum("srk,crk->csk", shifts, cands)          # (C, S, S)
    denom = qn[None] * cn[:, None]
    cos = np.where(denom > 1e-9, dots / np.maximum(denom, 1e-9), 0.0)
    col_valid = (qn[None] > 1e-9) & (cn[:, None] > 1e-9)
    n_valid = np.maximum(col_valid.sum(axis=-1), 1)
    return np.where(col_valid, 1.0 - cos, 0.0).sum(axis=-1) / n_valid


# ---------------------------------------------------------------------------
# device programs
# ---------------------------------------------------------------------------


def make_kf_snapshot():
    """`snap(state) -> dict` of everything the archive needs from a scan:
    the newest keyframe's pose, stamp, cloud, mask and descriptor, the live
    pose table and the two counters.  Every value is a fresh tensor
    (`clone`), so no later write to a state tensor can reach a result still
    queued for `drain`."""

    def snap(state: lio.LioState) -> dict:
        i = torch.clamp(state.store.count - 1, min=0).to(torch.int64)
        return {
            "arch_pose": state.store.poses[i].clone(),
            "arch_stamp": state.store.stamps[i].clone(),
            "arch_cloud": state.store.clouds[i].clone(),
            "arch_cloud_mask": state.store.cloud_masks[i].clone(),
            "arch_desc": state.sc_db.descriptors[i].clone(),
            "arch_all_poses": state.store.poses.clone(),
            "arch_kf_count": state.store.count.clone(),
            "arch_evict_count": state.evict_count.clone(),
        }

    return snap


def make_archive_verifier(cfg: Config):
    """`verify_and_queue(state, submap_xyz, submap_mask, init_pose,
    max_wander) -> (state, added () bool, fitness ())`: register the
    CURRENT keyframe's stored cloud against the re-promoted archive submap
    (performSCLoopClosure, mapOptmization.cpp:1163-1269, same fitness gate;
    each GN iteration is one launch of the fused kernel on CUDA tensors),
    then queue a between factor cur -> keyframe 0.

    The evicted candidate is no longer a graph variable, so the measurement
    enters as two existing factor types:

    - a between factor cur -> keyframe 0 (the rebased prior frame that
      absorbed the evicted chain): with X_cur measured against the archive's
      world and X_0 the current estimate, meas = X_cur_meas^-1 X_0;
    - an absolute position anchor on cur at the measured translation, in a
      dedicated unary slot (the last `max_archive_anchors` of the GPS
      region), because the rebased prior is translation-soft (1e8 m^2,
      :1933): a relative factor alone would float the whole graph instead
      of pulling the trajectory back onto the archived map.

    The JAX version's gates and slot choices are device selects; here they
    are the same selects, with `lio._first_free` for the first free slot."""
    s, l, r = cfg.static, cfg.loop, cfg.registration

    def verify_and_queue(state: lio.LioState, submap_xyz: torch.Tensor,
                         submap_mask: torch.Tensor, init_pose: torch.Tensor,
                         max_wander: float):
        dev = state.pose.device
        cur = torch.clamp(state.store.count - 1, min=0)
        ci = cur.to(torch.int64)
        submap = pc.voxel_downsample(pc.Cloud(xyz=submap_xyz, mask=submap_mask),
                                     r.mapping_surf_leaf_size,
                                     s.icp_submap_points)
        res = reg.register(state.store.clouds[ci], state.store.cloud_masks[ci],
                           submap.xyz, submap.mask, init_pose, r)
        fitness = res.mean_residual
        # displacement gate: the registration started at the SC hypothesis
        # (the archived candidate's pose); a result that wandered beyond
        # `max_wander` is a perceptual-aliasing match whose ABSOLUTE anchor
        # would corrupt the graph
        wander = torch.linalg.norm(res.pose[3:] - init_pose[3:])
        ok = ((fitness < l.fitness_score) & (res.num_inliers > 100)
              & (state.store.count >= 2) & (wander < max_wander)
              & torch.tensor(res.converged, device=dev))
        meas = se3.pose6_between(res.pose, state.graph.poses[0])
        info = (1.0 / torch.clamp(fitness, min=1e-3) ** 2).expand(6)
        slot, free = lio._first_free(state.pend_mask)
        add = ok & free
        state = lio._queue_loop(state, slot, add, cur.to(torch.int32),
                                torch.zeros_like(cur, dtype=torch.int32),
                                meas, info)
        # the anchor's slot: the first free one of the anchor region, else
        # the one with the OLDEST endpoint keyframe.  Variance floored at
        # 1.0 m^2 like the reference's GPS factors (addGPSFactor :2030).
        # Anchors do not advance gps_count: that counter drives the live
        # GPS ring, which anchors are not part of
        g = state.graph
        base = g.gps_i.shape[0] - s.max_archive_anchors
        amask = g.gps_mask[base:]
        afree, has_free = lio._first_free(amask)
        oldest = torch.argmin(torch.where(
            amask, g.gps_i[base:], torch.full_like(g.gps_i[base:], 2 ** 30)))
        gslot = base + torch.where(has_free, afree, oldest)
        g = g._replace(
            gps_i=lio._put(g.gps_i, gslot, cur.to(g.gps_i.dtype), add),
            gps_meas=lio._put(g.gps_meas, gslot, res.pose[3:], add),
            gps_info=lio._put(g.gps_info, gslot,
                              torch.clamp(info[3:], max=1.0), add),
            gps_mask=lio._put(g.gps_mask, gslot, True, add))
        return state._replace(graph=g), add, fitness

    return verify_and_queue
