"""Mesh-sharded mission backend (port of `lio_slam_tpu/parallel/mission.py`):
the persistent map and the keyframe clouds scale with the mesh.

`make_sharded_map_ops(mesh, cfg)` is a `MapOps` (`pipeline/lio.py`) that
runs the same mission step, one process per device, with

- the persistent `HashGrid` as per-rank shards: rank d owns an independent
  grid of T = `grid_table_size` buckets holding its 1/D chunk of every
  inserted cloud, so the mission's grid holds D·T buckets; the global view
  (`gather`) is the JAX package's (D·T, C, 3) table, rank d at rows
  [d·T, (d+1)·T);
- the keyframe cloud store sharded along its POINTS axis: rank d keeps
  points [d·P/D, (d+1)·P/D) of each keyframe cloud (JAX's
  P(None, axis, None)); a reader of whole clouds (the loop detector, the
  archive verifier) gathers just the keyframes it reads
  (`keyframe_rows`);
- registration's 5-NN as each rank's local 5-NN against its grid, merged
  across ranks (`parallel/registration.map_sharded_ne`), with the normal
  equations of each rank's scan chunk summed by one all_reduce;
- full rebuilds (after a loop or GPS factor) from each rank's chunk of every
  keyframe, with no communication;
- the full-graph correction through the column-sharded sparse solver
  (`parallel/sparse.py`) when `full_solver` selects the sparse backend,
  else the dense solver, replicated.

Poses, the factor graph, the Scan Context DB and the counters are
replicated: every rank computes them identically from the same inputs.
Every host branch of the step (the GN convergence read, the keyframe gate,
`needs_full_solve`) reads a replicated value or one that came out of a
collective, so the ranks issue the same collectives in the same order.
"""

from __future__ import annotations

import torch

from lio_slam_tpu_torch.config import Config
from lio_slam_tpu_torch.graph import solver as gsolver
from lio_slam_tpu_torch.graph import sparse as gsparse
from lio_slam_tpu_torch.ops import voxel_grid as vg
from lio_slam_tpu_torch.parallel import mesh as mesh_mod
from lio_slam_tpu_torch.parallel import registration as preg
from lio_slam_tpu_torch.parallel import sparse as psparse
from lio_slam_tpu_torch.pipeline import keyframes as kf
from lio_slam_tpu_torch.pipeline import lio as lio_mod
from lio_slam_tpu_torch.utils import pointcloud as pc


def make_sharded_map_ops(mesh, cfg: Config, axis: str = "data",
                         min_correspondences: int = 50,
                         k: int = 5) -> lio_mod.MapOps:
    """The sharded `MapOps` for `lio.make_lio_step(cfg, ops=)`.

    `cfg.registration.grid_table_size` counts buckets A RANK.  The
    surface-only incremental-map path only; `max_scan_points` and
    `max_keyframe_points` must divide by the mesh size."""
    r = cfg.registration
    s = cfg.static
    D = mesh_mod.axis_size(mesh, axis)
    me = mesh_mod.axis_index(mesh, axis)
    dev = mesh_mod.mesh_device(mesh)
    T = r.grid_table_size
    P = s.max_keyframe_points
    if s.max_scan_points % D or P % D:
        raise ValueError(
            f"max_scan_points={s.max_scan_points} and max_keyframe_points="
            f"{P} must divide by the mesh size {D}")

    def empty_grid():
        return vg.empty_grid(r.nn_radius, T, r.grid_max_per_cell, device=dev)

    def insert(grid, world_pts, mask):
        # each rank inserts its chunk of the scan
        chunk = world_pts.shape[0] // D
        sl = slice(me * chunk, (me + 1) * chunk)
        return vg.insert_points(grid, world_pts[sl], mask[sl],
                                halo=r.grid_halo)

    def rebuild(store):
        # the rank's grid from its chunk of every keyframe: no communication
        world = kf.transform_keyframe_clouds(store)
        return vg.build_grid(world.reshape(-1, 3),
                             store.cloud_masks.reshape(-1), r.nn_radius, T,
                             r.grid_max_per_cell, halo=r.grid_halo)

    def register(scan_xyz, scan_mask, grid, pose_guess):
        ne_fn = preg.map_sharded_ne(grid, scan_xyz, scan_mask, r, mesh,
                                    axis, k)
        return preg.gn_loop(ne_fn, scan_xyz, pose_guess, r,
                            min_correspondences)

    if lio_mod._use_sparse_solver(cfg):
        solve = psparse.make_sharded_sparse_solver(mesh, (axis,))
        full_solve = lambda g: solve(g, iterations=5).graph
        marginal_cov = gsparse.marginal_covariance_sparse
    else:
        full_solve = lambda g: gsolver.solve(g, g.pose_mask,
                                             iterations=5).graph
        marginal_cov = gsolver.marginal_covariance

    Pl = P // D

    def keyframe_cloud(cloud):
        sl = slice(me * Pl, (me + 1) * Pl)
        return pc.Cloud(xyz=cloud.xyz[:P][sl], mask=cloud.mask[:P][sl])

    def shard(state):
        """Cut a grid of D·T buckets and a store of P points a keyframe
        (the global layout) to this rank's slice; slices already the
        rank's stay as they are."""
        g, st = state.map_grid, state.store
        if D > 1 and g.table.shape[0] == D * T:
            g = g._replace(table=g.table[me * T:(me + 1) * T],
                           counts=g.counts[me * T:(me + 1) * T])
        if D > 1 and st.clouds.shape[1] == P:
            sl = slice(me * Pl, (me + 1) * Pl)
            st = st._replace(clouds=st.clouds[:, sl],
                             cloud_masks=st.cloud_masks[:, sl])
        return state._replace(map_grid=g, store=st)

    def gather(state, grid: bool = True):
        """The global view (a collective: every rank calls it): the store's
        clouds gathered by point, and with `grid` the grid by bucket."""
        st = state.store
        st = st._replace(
            clouds=mesh_mod.gather_sharded(st.clouds, mesh, 1, axis),
            cloud_masks=mesh_mod.gather_sharded(st.cloud_masks, mesh, 1, axis))
        state = state._replace(store=st)
        if grid:
            g = state.map_grid
            state = state._replace(map_grid=g._replace(
                table=mesh_mod.gather_sharded(g.table, mesh, 0, axis),
                counts=mesh_mod.gather_sharded(g.counts, mesh, 0, axis)))
        return state

    def keyframe_rows(store, idx):
        """Keyframes `idx` whole: this rank's points of each, gathered by
        point in one all_gather (the mask rides as a fourth channel)."""
        part = torch.cat([store.clouds[idx],
                          store.cloud_masks[idx][..., None].to(
                              store.clouds.dtype)], dim=-1)
        whole = mesh_mod.gather_sharded(part, mesh, 1, axis)
        return whole[..., :3].contiguous(), whole[..., 3] > 0

    return lio_mod.MapOps(empty_grid=empty_grid, register=register,
                          insert=insert, rebuild=rebuild,
                          full_solve=full_solve, marginal_cov=marginal_cov,
                          keyframe_cloud=keyframe_cloud, shard=shard,
                          gather=gather, keyframe_rows=keyframe_rows)


def make_sharded_mission(mesh, cfg: Config, axis: str = "data"):
    """(init_state, step, full_correct, ops) with the persistent map sharded
    over `mesh`: D x `grid_table_size` buckets in all, 1/D of the keyframe
    cloud memory a rank."""
    ops = make_sharded_map_ops(mesh, cfg, axis)
    dev = mesh_mod.mesh_device(mesh)
    step = lio_mod.make_lio_step(cfg, ops=ops, device=dev)
    full_correct = lio_mod.make_full_correction(cfg, ops=ops, device=dev)

    def init_state():
        return lio_mod.init_state(cfg, device=dev, ops=ops)

    return init_state, step, full_correct, ops
