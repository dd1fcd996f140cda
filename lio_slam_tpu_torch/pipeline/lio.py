"""The per-scan LIO mapping step (port of `lio_slam_tpu/pipeline/lio.py`,
mapOptmization.cpp:432-506 laserCloudInfoHandler):

    updateInitialGuess -> downsampleCurrentScan -> scan2MapOptimization
    -> transformUpdate -> saveKeyFramesAndFactor (window solve, map insert)

over fixed-capacity masked tensors on one device, plus what follows a loop
or GPS factor: `make_full_correction` (the full-graph solve, the store
brought up to date, the voxel map rebuilt) and `inject_loop_constraint`.
The JAX package's `lax.cond`s (eviction at capacity, keyframe save, the GPS
covariance gate, the correction itself) are host branches on a device bool
here: one device-to-host read each.

`local_map_mode="incremental"` registers against the persistent voxel map;
"rebuild" assembles the local map from the nearby keyframes every scan
(extractNearby / extractCloud) and builds its grid.  With
`use_corner_features` the scan's LOAM corners (`ScanInput.corner`) add a
point-to-line term against a corner map assembled the same way, and each
keyframe stores its downsampled corners.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lio_slam_tpu_torch.config import Config
from lio_slam_tpu_torch.graph import factors as F
from lio_slam_tpu_torch.graph import solver
from lio_slam_tpu_torch.graph import sparse
from lio_slam_tpu_torch.ops import registration as reg
from lio_slam_tpu_torch.ops import scancontext as sc_mod
from lio_slam_tpu_torch.ops import voxel_grid as vg
from lio_slam_tpu_torch.pipeline import keyframes as kf
from lio_slam_tpu_torch.utils import pointcloud as pc
from lio_slam_tpu_torch.utils import se3


class LioState(NamedTuple):
    store: kf.KeyframeStore
    graph: F.PoseGraph
    map_grid: vg.HashGrid          # persistent world-frame voxel map
    sc_db: sc_mod.ScanContextDB
    last_loop_kf: torch.Tensor     # () int32
    needs_full_solve: torch.Tensor  # () bool
    loop_count: torch.Tensor       # () int32
    gps_count: torch.Tensor        # () int32
    evict_count: torch.Tensor      # () int32
    pose: torch.Tensor             # (6,) current transformTobeMapped
    last_incre_pose: torch.Tensor  # (6,)
    last_gps_pos: torch.Tensor     # (3,)
    degenerate: torch.Tensor       # () bool
    loop_closed: torch.Tensor      # () bool
    pend_i: torch.Tensor           # (Q,) int32
    pend_j: torch.Tensor           # (Q,) int32
    pend_meas: torch.Tensor        # (Q, 6)
    pend_info: torch.Tensor        # (Q, 6)
    pend_mask: torch.Tensor        # (Q,) bool


class ScanInput(NamedTuple):
    cloud: pc.Cloud                # deskewed scan, body frame
    stamp: torch.Tensor            # () seconds
    init_guess: torch.Tensor       # (6,) absolute pose guess
    guess_valid: torch.Tensor      # () bool
    imu_rpy: torch.Tensor          # (3,)
    imu_available: torch.Tensor    # () bool
    gps_pos: torch.Tensor          # (3,)
    gps_info: torch.Tensor         # (3,)
    gps_valid: torch.Tensor        # () bool
    # LOAM corner features (None unless cfg.registration.use_corner_features)
    corner: pc.Cloud = None


class StepOutput(NamedTuple):
    pose: torch.Tensor             # (6,) global odometry
    incremental: torch.Tensor      # (6,) scan-to-scan increment
    degenerate: torch.Tensor       # () bool
    is_keyframe: bool              # host value (the save branch reads it)
    num_inliers: torch.Tensor      # () int32
    registration_iters: int        # host value (GN loop count)
    evictions: torch.Tensor        # () int32 cumulative evictions


def empty_scan_input(capacity: int, device=None) -> ScanInput:
    """A scan of `capacity` masked points with every input off."""
    f32 = dict(dtype=torch.float32, device=device)
    no = torch.zeros((), dtype=torch.bool, device=device)
    return ScanInput(
        cloud=pc.Cloud(xyz=torch.zeros((capacity, 3), **f32),
                       mask=torch.zeros(capacity, dtype=torch.bool,
                                        device=device)),
        stamp=torch.zeros((), **f32), init_guess=torch.zeros(6, **f32),
        guess_valid=no, imu_rpy=torch.zeros(3, **f32), imu_available=no,
        gps_pos=torch.zeros(3, **f32), gps_info=torch.zeros(3, **f32),
        gps_valid=no)


class MapOps(NamedTuple):
    """Persistent-map and solver backend of the step: one device
    (`default_map_ops`) or a mesh (`parallel/mission.make_sharded_map_ops`,
    where each rank holds its slice of the grid and the keyframe clouds)."""

    empty_grid: object    # () -> HashGrid
    register: object      # (scan_xyz, scan_mask, grid, pose_guess) -> RegistrationResult
    insert: object        # (grid, world_pts, mask) -> HashGrid
    rebuild: object       # (store) -> HashGrid (full map rebuild)
    full_solve: object    # (graph) -> graph (the x5 full-graph correction)
    marginal_cov: object  # (graph, idx) -> (6, 6)
    # The JAX MapOps' `constrain` (sharding annotations on the persistent
    # state) is explicit slicing here; on one device all three are
    # identities.
    keyframe_cloud: object  # (cloud) -> the points of a keyframe's cloud
    #                         this rank stores (JAX: constrain's P(None,
    #                         axis) on store.clouds / cloud_masks)
    shard: object         # (state) -> the state with a grid or store in the
    #                       global layout cut to this rank's slice (JAX:
    #                       constrain)
    gather: object        # (state, grid=True) -> the global view of the
    #                       sharded leaves, the JAX package's layout (JAX:
    #                       none needed, a sharded jax.Array is global)
    keyframe_rows: object  # (store, idx) -> (clouds, masks) of keyframes
    #                        `idx` whole (JAX: indexing the sharded
    #                        store.clouds gathers their points)


def _use_sparse_solver(cfg: Config) -> bool:
    """Full-graph solver selection (StaticConfig.full_solver): the dense
    (K*6)^2 assembly at small capacities, the block-tridiagonal + Woodbury
    factorization (graph/sparse.py) above 512 keyframes."""
    fs = cfg.static.full_solver
    if fs not in ("auto", "dense", "sparse"):
        raise ValueError(f"full_solver must be auto|dense|sparse, got {fs!r}")
    return fs == "sparse" or (fs == "auto" and cfg.static.max_keyframes > 512)


def default_map_ops(cfg: Config, device=None) -> MapOps:
    r = cfg.registration

    def register(scan_xyz, scan_mask, grid, pose_guess):
        return reg.register_with_grid(scan_xyz, scan_mask, grid, pose_guess, r)

    def insert(grid, world_pts, mask):
        return vg.insert_points(grid, world_pts, mask, halo=r.grid_halo)

    def rebuild(store):
        all_world = kf.transform_keyframe_clouds(store)
        return vg.build_grid(all_world.reshape(-1, 3),
                             store.cloud_masks.reshape(-1), r.nn_radius,
                             r.grid_table_size, r.grid_max_per_cell,
                             halo=r.grid_halo)

    if _use_sparse_solver(cfg):
        full_solve = lambda g: sparse.solve_sparse(g, iterations=5).graph
        marginal_cov = sparse.marginal_covariance_sparse
    else:
        full_solve = lambda g: solver.solve(g, g.pose_mask,
                                            iterations=5).graph
        marginal_cov = solver.marginal_covariance

    return MapOps(
        empty_grid=lambda: vg.empty_grid(r.nn_radius, r.grid_table_size,
                                         r.grid_max_per_cell, device=device),
        register=register, insert=insert, rebuild=rebuild,
        full_solve=full_solve, marginal_cov=marginal_cov,
        keyframe_cloud=lambda cloud: cloud, shard=lambda state: state,
        gather=lambda state, grid=True: state,
        keyframe_rows=kf.keyframe_rows)


def init_state(cfg: Config, device=None, ops: MapOps = None) -> LioState:
    """The empty mission state; with a sharded `ops`, this rank's slice."""
    if ops is None:
        ops = default_map_ops(cfg, device)
    s = cfg.static
    K = s.max_keyframes
    B = K - 1 + s.max_loop_queue * 8
    G = s.max_gps_queue * 8 + s.max_archive_anchors
    Q = s.max_loop_queue
    corner_pts = (s.max_corner_points
                  if cfg.registration.use_corner_features else 1)
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return ops.shard(LioState(
        store=kf.empty_store(K, s.max_keyframe_points,
                             corner_points_per_kf=corner_pts, device=device),
        graph=F.empty_graph(K, B, G, device=device),
        map_grid=ops.empty_grid(),
        sc_db=sc_mod.empty_db(K, s.sc_num_ring, s.sc_num_sector, device=device),
        last_loop_kf=torch.full((), -1, **i32),
        needs_full_solve=torch.zeros((), **b),
        loop_count=torch.zeros((), **i32), gps_count=torch.zeros((), **i32),
        evict_count=torch.zeros((), **i32),
        pose=torch.zeros(6, **f32), last_incre_pose=torch.zeros(6, **f32),
        last_gps_pos=torch.full((3,), 1e9, **f32),
        degenerate=torch.zeros((), **b), loop_closed=torch.zeros((), **b),
        pend_i=torch.zeros(Q, **i32), pend_j=torch.zeros(Q, **i32),
        pend_meas=torch.zeros((Q, 6), **f32),
        pend_info=torch.zeros((Q, 6), **f32),
        pend_mask=torch.zeros(Q, **b)))


def _update_initial_guess(state: LioState, inp: ScanInput) -> torch.Tensor:
    """updateInitialGuess (:1438-1502): the first scan takes the IMU roll
    and pitch (yaw zeroed); later scans the IMU-odometry guess when valid,
    else the last pose."""
    first = state.store.count == 0
    rp = torch.tensor([1.0, 1.0, 0.0], dtype=torch.float32,
                      device=state.pose.device)
    first_pose = torch.cat([
        torch.where(inp.imu_available, inp.imu_rpy * rp, torch.zeros_like(rp)),
        torch.zeros_like(rp)])
    guess = torch.where(inp.guess_valid, inp.init_guess, state.pose)
    return torch.where(first, first_pose, guess)


def _first_free(mask: torch.Tensor):
    """(index of the first False of `mask` (0 if none), whether there is
    one), as `jnp.argmin` of a bool mask answers."""
    n = mask.shape[0]
    idx = torch.arange(n, device=mask.device)
    first = torch.min(torch.where(mask, torch.full_like(idx, n), idx))
    free = first < n
    return torch.where(free, first, torch.zeros_like(first)), free


def _put(arr: torch.Tensor, slot: torch.Tensor, val, add: torch.Tensor):
    """`arr` with `val` written at `slot` where the device bool `add` holds,
    `arr` as it is where not (no host read)."""
    new = arr.clone()
    new[slot] = val
    return torch.where(add, new, arr)


def _add_gps_factor(state: LioState, inp: ScanInput, new_idx: torch.Tensor,
                    cfg: Config, ops: MapOps) -> LioState:
    """addGPSFactor gates (:1946-2041): a valid fix, enough travel since the
    datum, spacing from the previous GPS factor, and (computed only when
    those hold: one host read) a pose covariance above the threshold."""
    g = state.graph
    ni = torch.clamp(new_idx, min=0).to(torch.int64)
    first_pos = state.store.poses[0, 3:]
    cur_pos = state.store.poses[ni, 3:]
    traveled = torch.linalg.norm(cur_pos - first_pos) > cfg.gps.min_travel_before_gps
    spaced = torch.linalg.norm(cur_pos - state.last_gps_pos) > cfg.gps.gps_distance_frequency
    if not bool(inp.gps_valid & traveled & spaced):   # host branch (JAX lax.cond)
        return state
    cov = ops.marginal_cov(g, new_idx)
    add = ((cov[3, 3] > cfg.gps.pose_cov_threshold)
           | (cov[4, 4] > cfg.gps.pose_cov_threshold))
    # slot allocation: the first FREE slot (keyframe eviction clears gps_mask
    # without touching gps_count); with none free, the ring recycles the
    # OLDEST factor.  Only the live region [0, G_live): the tail slots are
    # reserved for archive anchors
    G_live = g.gps_i.shape[0] - cfg.static.max_archive_anchors
    free_slot, has_free = _first_free(g.gps_mask[:G_live])
    slot = torch.where(has_free, free_slot,
                       (state.gps_count % G_live).to(torch.int64))
    # useGpsElevation (:1991-1995): unless enabled, the current estimate's z
    # stands in, so the factor constrains x/y only
    gps_meas = inp.gps_pos
    if not cfg.gps.use_gps_elevation:
        gps_meas = torch.cat([gps_meas[:2], state.store.poses[ni, 5:6]])

    g = g._replace(
        gps_i=_put(g.gps_i, slot, new_idx.to(g.gps_i.dtype), add),
        gps_meas=_put(g.gps_meas, slot, gps_meas, add),
        gps_info=_put(g.gps_info, slot, inp.gps_info, add),
        gps_mask=_put(g.gps_mask, slot, True, add))
    return state._replace(
        graph=g, gps_count=state.gps_count + add.to(torch.int32),
        last_gps_pos=torch.where(add, cur_pos, state.last_gps_pos),
        # addGPSFactor sets aLoopIsClosed (:2037): a GPS factor triggers the
        # same full correction and map rebuild as a loop closure; without it
        # the window solve's corrections leave ghost geometry in the
        # incremental voxel map
        loop_closed=state.loop_closed | add)


def _consume_pending_loops(state: LioState, cfg: Config) -> LioState:
    """addLoopFactor (:2043-2062): queued loop constraints into the
    between-factor loop region (ring-allocated; masked entries go to a dump
    row)."""
    g = state.graph
    K = state.store.poses.shape[0]
    Q = state.pend_mask.shape[0]
    B = g.bt_i.shape[0]
    base = K - 1
    n_slots = B - base
    if Q > n_slots:
        raise ValueError(f"max_loop_queue={Q} exceeds the loop-factor region "
                         f"({n_slots} slots)")
    put = state.pend_mask
    offsets = torch.cumsum(put.to(torch.int32), 0) - 1
    slots = torch.where(put, base + (state.loop_count + offsets) % n_slots,
                        torch.full_like(offsets, B)).to(torch.int64)

    def scat(arr, vals):
        padded = torch.cat([arr, torch.zeros((1,) + arr.shape[1:],
                                             dtype=arr.dtype,
                                             device=arr.device)], dim=0)
        padded[slots] = vals
        return padded[:B]

    g = g._replace(
        bt_i=scat(g.bt_i, state.pend_i), bt_j=scat(g.bt_j, state.pend_j),
        bt_meas=scat(g.bt_meas, state.pend_meas),
        bt_info=scat(g.bt_info, state.pend_info),
        bt_mask=scat(g.bt_mask, torch.ones_like(put)))
    n_added = torch.sum(put).to(torch.int32)
    return state._replace(graph=g, loop_count=state.loop_count + n_added,
                          loop_closed=n_added > 0,
                          pend_mask=torch.zeros_like(put))


def _evict_oldest(state: LioState) -> LioState:
    """Ring eviction of keyframe 0 at capacity with graph rebase: prior and
    between(x0, x1) fold into a prior on x1; index-aligned stores shift
    left; the odometry chain region rolls; factors on the evicted pose drop."""
    store, g = state.store, state.graph
    K = store.poses.shape[0]
    c = K - 1

    new_prior_info = torch.where(
        g.bt_mask[0],
        1.0 / (1.0 / torch.clamp(g.prior_info, min=1e-12)
               + 1.0 / torch.clamp(g.bt_info[0], min=1e-12)),
        g.prior_info)
    new_prior_pose = g.poses[1]

    def roll1(a):
        return torch.roll(a, -1, dims=0)

    cloud_masks = roll1(store.cloud_masks)
    cloud_masks[K - 1] = False
    corner_masks = roll1(store.corner_masks)
    corner_masks[K - 1] = False
    store = store._replace(
        poses=roll1(store.poses), stamps=roll1(store.stamps),
        clouds=roll1(store.clouds), cloud_masks=cloud_masks,
        corner_clouds=roll1(store.corner_clouds), corner_masks=corner_masks,
        count=store.count - 1)
    sc_db = state.sc_db._replace(
        descriptors=roll1(state.sc_db.descriptors),
        ring_keys=roll1(state.sc_db.ring_keys),
        count=state.sc_db.count - 1)

    pose_mask = roll1(g.pose_mask)
    pose_mask[K - 1] = False

    def shift_chain(a):
        return torch.cat([torch.roll(a[:c], -1, dims=0), a[c:]], dim=0)

    bt_i = shift_chain(g.bt_i) - 1
    bt_j = shift_chain(g.bt_j) - 1
    bt_mask = shift_chain(g.bt_mask)
    bt_mask[c - 1] = False
    bt_mask = bt_mask & (bt_i >= 0) & (bt_j >= 0)
    gps_i = g.gps_i - 1
    gps_mask = g.gps_mask & (gps_i >= 0)
    g = g._replace(
        poses=roll1(g.poses), pose_mask=pose_mask,
        prior_pose=new_prior_pose, prior_info=new_prior_info,
        bt_i=torch.clamp(bt_i, 0, K - 1), bt_j=torch.clamp(bt_j, 0, K - 1),
        bt_meas=shift_chain(g.bt_meas), bt_info=shift_chain(g.bt_info),
        bt_mask=bt_mask, gps_i=torch.clamp(gps_i, 0, K - 1),
        gps_mask=gps_mask)

    pend_i = state.pend_i - 1
    pend_j = state.pend_j - 1
    return state._replace(
        store=store, graph=g, sc_db=sc_db,
        last_loop_kf=torch.clamp(state.last_loop_kf - 1, min=-1),
        pend_i=torch.clamp(pend_i, 0, K - 1),
        pend_j=torch.clamp(pend_j, 0, K - 1),
        pend_mask=state.pend_mask & (pend_i >= 0) & (pend_j >= 0),
        evict_count=state.evict_count + 1)


def _save_keyframe(state: LioState, inp: ScanInput, pose: torch.Tensor,
                   scan_ds: pc.Cloud, cfg: Config,
                   corner_ds: pc.Cloud = None,
                   ops: MapOps = None) -> LioState:
    """saveKeyFramesAndFactor (:2064-2171) + window-scope correctPoses.  The
    keyframe's cloud goes into the incremental voxel map; the rebuild-mode
    map is assembled from the store instead."""
    if ops is None:
        ops = default_map_ops(cfg, pose.device)
    K = state.store.poses.shape[0]
    if bool(state.store.count >= K):          # host branch (JAX lax.cond)
        state = _evict_oldest(state)
    g = state.graph
    prev_idx = state.store.count - 1
    new_idx = state.store.count
    first = new_idx == 0
    dev = pose.device

    g = g._replace(
        prior_pose=torch.where(first, pose, g.prior_pose),
        prior_info=torch.where(
            first, F.info_from_variances(cfg.keyframe.prior_sigmas, dev),
            g.prior_info))

    prev_c = torch.clamp(prev_idx, min=0).to(torch.int64)
    meas = se3.pose6_between(state.store.poses[prev_c], pose)
    odom_info = F.info_from_variances(cfg.keyframe.odom_sigmas, dev)
    use_between = ~first
    bt_i, bt_j = g.bt_i.clone(), g.bt_j.clone()
    bt_meas, bt_info = g.bt_meas.clone(), g.bt_info.clone()
    bt_mask = g.bt_mask.clone()
    bt_i[prev_c] = torch.where(use_between, prev_idx, bt_i[prev_c])
    bt_j[prev_c] = torch.where(use_between, new_idx, bt_j[prev_c])
    bt_meas[prev_c] = torch.where(use_between, meas, bt_meas[prev_c])
    bt_info[prev_c] = torch.where(use_between, odom_info, bt_info[prev_c])
    bt_mask[prev_c] = use_between | bt_mask[prev_c]
    g = g._replace(bt_i=bt_i, bt_j=bt_j, bt_meas=bt_meas, bt_info=bt_info,
                   bt_mask=bt_mask)

    store = kf.add_keyframe(state.store, pose, inp.stamp,
                            ops.keyframe_cloud(scan_ds), corner=corner_ds)
    ni = new_idx.to(torch.int64)
    poses, pose_mask = g.poses.clone(), g.pose_mask.clone()
    poses[ni] = pose
    pose_mask[ni] = True
    g = g._replace(poses=poses, pose_mask=pose_mask)
    desc = sc_mod.make_descriptor(
        scan_ds.xyz, scan_ds.mask, max_radius=cfg.loop.sc_max_radius,
        lidar_height=cfg.loop.sc_lidar_height,
        num_ring=cfg.static.sc_num_ring, num_sector=cfg.static.sc_num_sector)
    state = state._replace(store=store, graph=g,
                           sc_db=sc_mod.add_descriptor(state.sc_db, desc))
    state = _consume_pending_loops(state, cfg)
    if cfg.gps.use_gps:
        state = _add_gps_factor(state, inp, new_idx, cfg, ops)

    g = solver.solve_window_compact(state.graph, store.count,
                                    cfg.static.window_size, iterations=2)
    store = store._replace(poses=torch.where(g.pose_mask[:, None], g.poses,
                                             store.poses))
    new_pose = g.poses[ni]
    if cfg.registration.local_map_mode == "incremental":
        Rn, tn = se3.pose6_to_Rt(new_pose)
        world_pts = se3.transform_points(Rn, tn, scan_ds.xyz)
        state = state._replace(map_grid=ops.insert(state.map_grid, world_pts,
                                                   scan_ds.mask))
    return state._replace(store=store, graph=g, pose=new_pose,
                          needs_full_solve=state.needs_full_solve | state.loop_closed,
                          loop_closed=torch.zeros_like(state.loop_closed))


def inject_loop_constraint(state: LioState, i, j, meas: torch.Tensor,
                           info: torch.Tensor):
    """External loop-constraint intake (detectLoopClosureExternal,
    mapOptmization.cpp:1306-1358): a third-party detector posts a
    keyframe-pair constraint; it is queued like an internally detected loop
    and consumed by the next keyframe save's addLoopFactor.

    `meas` is the measured relative pose X_i^-1 X_j (pose6, gtsam between
    convention), `info` the (6,) information diagonal.  Returns
    (state, accepted () bool): refused when an endpoint is not a live
    keyframe or the pending queue is full."""
    dev = state.pend_mask.device
    i = torch.as_tensor(i, dtype=torch.int32, device=dev)
    j = torch.as_tensor(j, dtype=torch.int32, device=dev)
    slot, free = _first_free(state.pend_mask)
    n = state.store.count
    add = free & (i >= 0) & (j >= 0) & (i < n) & (j < n) & (i != j)

    return _queue_loop(state, slot, add, i, j, meas.to(dev), info.to(dev)), add


def _queue_loop(state: LioState, slot, add, i, j, meas, info) -> LioState:
    """The pending-loop queue with the constraint (i, j, meas, info) at
    `slot` where the device bool `add` holds."""
    return state._replace(
        pend_i=_put(state.pend_i, slot, i, add),
        pend_j=_put(state.pend_j, slot, j, add),
        pend_meas=_put(state.pend_meas, slot, meas, add),
        pend_info=_put(state.pend_info, slot, info, add),
        pend_mask=_put(state.pend_mask, slot, True, add))


def make_full_correction(cfg: Config, ops: MapOps = None, device=None):
    """Full-graph GN after loop closures and GPS factors (correctPoses,
    :2173-2204, with the isam x5 extra updates, :2085-2092): every pose
    solved again, the store brought up to date, the voxel map rebuilt from
    the corrected keyframes.  `full_correct(state)` reads
    `state.needs_full_solve` (one device-to-host read) and returns the state
    as it is when the flag is down."""
    if ops is None:
        ops = default_map_ops(cfg, device)

    def full_correct(state: LioState) -> LioState:
        if not bool(state.needs_full_solve):       # host branch (JAX lax.cond)
            return state
        g = ops.full_solve(state.graph)
        store = state.store._replace(poses=torch.where(
            g.pose_mask[:, None], g.poses, state.store.poses))
        last = torch.clamp(store.count - 1, min=0).to(torch.int64)
        state = state._replace(
            graph=g, store=store, pose=g.poses[last],
            needs_full_solve=torch.zeros_like(state.needs_full_solve))
        if cfg.registration.local_map_mode == "incremental":
            state = state._replace(map_grid=ops.rebuild(store))
        return state

    return full_correct


def make_lio_step(cfg: Config, ops: MapOps = None, device=None):
    """The per-scan step for `cfg`: `step(state, inp) -> (state, out)`.  A
    custom `ops` serves the surface-only incremental-map path only."""
    s = cfg.static
    r = cfg.registration
    if r.scan_downsample not in ("packed", "voxel"):
        raise NotImplementedError(f"scan_downsample={r.scan_downsample!r} is "
                                  "not ported")
    if ops is None:
        ops = default_map_ops(cfg, device)
    elif r.use_corner_features or r.local_map_mode != "incremental":
        raise ValueError("a custom MapOps backend requires the surf-only "
                         "incremental-map mission path")
    nearby = dict(radius=r.surrounding_radius, recent_sec=r.recent_window_sec,
                  max_selected=cfg.output.local_map_keyframes)

    def lio_step(state: LioState, inp: ScanInput):
        pose_guess = _update_initial_guess(state, inp)
        if r.scan_downsample == "packed":
            scan_ds = pc.packed_voxel_downsample(
                inp.cloud, r.mapping_surf_leaf_size, s.max_scan_points)
        else:
            scan_ds = pc.voxel_downsample(inp.cloud, r.mapping_surf_leaf_size,
                                          s.max_scan_points)
        use_corner = r.use_corner_features and inp.corner is not None
        corner_ds = None
        if use_corner:
            corner_ds = pc.voxel_downsample(inp.corner,
                                            r.mapping_corner_leaf_size,
                                            s.max_corner_points)
            corner_map = kf.assemble_corner_map(
                state.store, pose_guess[3:], inp.stamp,
                leaf_size=r.mapping_corner_leaf_size,
                map_capacity=s.max_corner_map_points, **nearby)
        has_map = state.store.count > 0
        if r.local_map_mode == "incremental":
            if use_corner:
                res = reg.register_loam_with_grid(
                    scan_ds.xyz, scan_ds.mask & has_map, state.map_grid,
                    corner_ds.xyz, corner_ds.mask & has_map,
                    corner_map.xyz, corner_map.mask, pose_guess, r)
            else:
                res = ops.register(scan_ds.xyz, scan_ds.mask & has_map,
                                   state.map_grid, pose_guess)
        else:
            local_map = kf.assemble_local_map(
                state.store, pose_guess[3:], inp.stamp,
                leaf_size=r.mapping_surf_leaf_size,
                map_capacity=s.max_map_points, **nearby)
            if use_corner:
                res = reg.register_loam(
                    scan_ds.xyz, scan_ds.mask & has_map,
                    local_map.xyz, local_map.mask,
                    corner_ds.xyz, corner_ds.mask & has_map,
                    corner_map.xyz, corner_map.mask, pose_guess, r)
            else:
                res = reg.register(scan_ds.xyz, scan_ds.mask & has_map,
                                   local_map.xyz, local_map.mask,
                                   pose_guess, r)
        pose = torch.where(has_map, res.pose, pose_guess)
        pose = reg.transform_update(pose, inp.imu_rpy, inp.imu_available,
                                    cfg.imu.imu_rpy_weight,
                                    r.rotation_tolerance, r.z_tolerance)
        is_kf = bool(kf.should_add_keyframe(state.store, pose,
                                            cfg.keyframe.angle_threshold,
                                            cfg.keyframe.dist_threshold))
        state = state._replace(pose=pose, degenerate=res.degenerate)
        if is_kf:                              # host branch (JAX lax.cond)
            state = _save_keyframe(state, inp, pose, scan_ds, cfg,
                                   corner_ds=corner_ds, ops=ops)
        incremental = se3.pose6_between(state.last_incre_pose, state.pose)
        out = StepOutput(pose=state.pose, incremental=incremental,
                         degenerate=res.degenerate, is_keyframe=is_kf,
                         num_inliers=res.num_inliers,
                         registration_iters=res.iterations,
                         evictions=state.evict_count)
        return state._replace(last_incre_pose=state.pose), out

    return lio_step
