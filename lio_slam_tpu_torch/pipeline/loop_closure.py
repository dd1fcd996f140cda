"""Loop-closure detection + verification (port of
`lio_slam_tpu/pipeline/loop_closure.py`, the reference's 1 Hz loop thread,
mapOptmization.cpp:1054-1436):

- `detectLoopClosureDistance` (:1271-1304): radius search (15 m) over
  keyframe positions with a > 30 s time gap, here a masked distance argmin.
- `performSCLoopClosure` (:1163-1269): Scan Context retrieval
  (ops/scancontext.py) with the matched yaw as the initial guess.
- `loopFindNearKeyframes` (:1360-1383): the +-25-keyframe submap.
- verification (:1111-1124): the reference runs point-to-point ICP; here,
  as in the JAX package, the point-to-plane GN registration against a grid
  built over the submap (`registration.register`), so on CUDA tensors every
  GN iteration of a verification is one launch of the fused kernel.  Accept
  when the weighted mean residual is under the fitness gate.
- accepted constraints are queued into `LioState.pend_*` and consumed by
  the next keyframe save's `addLoopFactor` (pipeline/lio.py).

Cadence is the host's job (the runner calls `detect_loops` every N scans).
The JAX package's `lax.cond`s are host branches: one device-to-host read a
cycle for the candidates, then the GN loop's reads for each verification.
"""

from __future__ import annotations

import torch

from lio_slam_tpu_torch.config import Config
from lio_slam_tpu_torch.ops import registration as reg
from lio_slam_tpu_torch.ops import scancontext as sc
from lio_slam_tpu_torch.pipeline import keyframes as kf
from lio_slam_tpu_torch.pipeline import lio as lio_mod
from lio_slam_tpu_torch.utils import pointcloud as pc
from lio_slam_tpu_torch.utils import se3


def _submap_around(store, center_idx: torch.Tensor, search_num: int,
                   capacity: int, leaf: float,
                   rows=kf.keyframe_rows) -> pc.Cloud:
    """loopFindNearKeyframes: clouds of keyframes [center-n, center+n],
    transformed to world, merged + downsampled.  `rows` reads the clouds
    (`MapOps.keyframe_rows`)."""
    K = store.clouds.shape[0]
    dev = store.clouds.device
    lo = torch.clamp(center_idx - search_num, 0, K - 1)
    take = 2 * search_num + 1
    idx = torch.clamp(lo + torch.arange(take, device=dev), 0, K - 1)
    valid_kf = (idx < store.count) & (idx >= 0)
    idx = idx.to(torch.int64)
    clouds, masks = rows(store, idx)
    masks = masks & valid_kf[:, None]
    R, t = se3.pose6_to_Rt(store.poses[idx])
    world = torch.einsum("sij,spj->spi", R, clouds) + t[:, None, :]
    merged = pc.Cloud(xyz=world.reshape(-1, 3), mask=masks.reshape(-1))
    return pc.voxel_downsample(merged, leaf, capacity)


def make_loop_detector(cfg: Config, rows=kf.keyframe_rows):
    """`detect_loops(state) -> (state, aux)`: one detector cycle.  `rows`
    reads the keyframe clouds it verifies against (`MapOps.keyframe_rows`:
    in a sharded mission a collective, made only for the current keyframe
    and the candidates' submaps, the same on every rank).  `aux`
    holds the cycle's provenance as device tensors: `loop_accepted` (2,)
    bool for [radius search, Scan Context], `loop_pair_i` / `loop_pair_j`
    (2,) the matched keyframe pair, `loop_fitness` (2,) the verification's
    mean residual (0 where none ran), and `loop_iters`, a host list of the
    GN iterations of each verification that ran."""
    l = cfg.loop
    s = cfg.static

    def detect_loops(state: lio_mod.LioState):
        store = state.store
        K = store.poses.shape[0]
        dev = store.poses.device
        cur = store.count - 1
        cur_c = torch.clamp(cur, min=0).to(torch.int64)
        runnable = (store.count >= 2) & (cur != state.last_loop_kf)

        cur_pose = store.poses[cur_c]
        cur_stamp = store.stamps[cur_c]

        # --- RS candidate: nearest keyframe within radius, > time_diff older
        kf_mask = torch.arange(K, device=dev) < store.count
        d2 = torch.sum((store.poses[:, 3:] - cur_pose[3:]) ** 2, dim=-1)
        old_enough = (cur_stamp - store.stamps) > l.time_diff
        rs_elig = kf_mask & old_enough & (d2 < l.search_radius ** 2)
        rs_idx = torch.argmin(torch.where(
            rs_elig, d2, torch.full_like(d2, float("inf"))))
        rs_found = torch.any(rs_elig)

        # --- SC candidate ---
        match = sc.detect(state.sc_db, state.sc_db.descriptors[cur_c],
                          dist_threshold=l.sc_dist_thresh,
                          num_candidates=s.sc_candidates,
                          exclude_recent=l.sc_exclude_recent)
        sc_idx = torch.clamp(match.index, min=0).to(torch.int64)
        # SC gives yaw(query) - yaw(candidate); its pose hypothesis for the
        # current scan is the candidate pose yawed by that amount (position
        # from the candidate: SC carries no translation)
        yaw_fix = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0, 0.0],
                               device=dev) * match.yaw
        sc_init = se3.pose6_compose(store.poses[sc_idx], yaw_fix)

        def verify(cand_idx, init_pose):
            """Verify cur against the candidate's submap; returns (accept,
            measured between cur->cand, info, fitness, GN iterations)."""
            submap = _submap_around(store, cand_idx, l.search_num,
                                    s.icp_submap_points,
                                    cfg.registration.mapping_surf_leaf_size,
                                    rows)
            cur_xyz, cur_mask = rows(store, cur_c[None])
            r = reg.register(cur_xyz[0], cur_mask[0], submap.xyz,
                             submap.mask, init_pose, cfg.registration)
            fitness = r.mean_residual
            ok = ((fitness < l.fitness_score) & (r.num_inliers > 100)
                  & r.converged)
            meas = se3.pose6_between(r.pose, store.poses[cand_idx])
            info = (1.0 / torch.clamp(fitness, min=1e-3) ** 2).expand(6)
            return ok, meas, info, fitness, r.iterations

        def queue(state, add, j_idx, meas, info):
            slot, free = lio_mod._first_free(state.pend_mask)
            add = add & free
            return lio_mod._queue_loop(state, slot, add, cur.to(torch.int32),
                                       j_idx.to(torch.int32), meas, info), add

        # BOTH candidates are verified each cycle, radius search first, like
        # the reference's thread (performRSLoopClosure AND
        # performSCLoopClosure every tick, :1062-1064): an RS candidate in
        # radius that fails the fitness gate must not starve an SC loop
        founds = torch.stack([runnable & rs_found,
                              runnable & (match.index >= 0)
                              & (sc_idx != rs_idx)]).tolist()  # the host read
        accepted = [torch.zeros((), dtype=torch.bool, device=dev)] * 2
        fits = [torch.zeros((), dtype=torch.float32, device=dev)] * 2
        iters = []
        for k, (cand, init) in enumerate(((rs_idx, cur_pose),
                                          (sc_idx, sc_init))):
            if not founds[k]:
                continue
            ok, meas, info, fits[k], n_it = verify(cand, init)
            iters.append(n_it)
            state, accepted[k] = queue(state, ok, cand, meas, info)
            state = state._replace(last_loop_kf=torch.where(
                accepted[k], cur.to(state.last_loop_kf.dtype),
                state.last_loop_kf))
        aux = {"loop_accepted": torch.stack(accepted),
               "loop_pair_i": cur_c.expand(2),
               "loop_pair_j": torch.stack([rs_idx, sc_idx]),
               "loop_fitness": torch.stack(fits),
               "loop_iters": iters}
        return state, aux

    return detect_loops
