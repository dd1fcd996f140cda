"""Multi-device scan-to-map registration (port of
`lio_slam_tpu/parallel/registration.py`), one process per device.

The reference parallelizes its registration loop with an OpenMP parallel-for
over scan points (`mapOptmization.cpp:1622`).  Here the same data axis runs
over the ranks of a mesh (`parallel/mesh.py`):

- `make_sharded_register`: the scan sharded, the map grid replicated; each
  rank builds the 6x6 normal equations of its scan slice and one
  `all_reduce` sums them; the GN loop runs replicated on the sum.
- `make_map_sharded_register`: the MAP sharded, so grid capacity scales with
  the mesh: each rank's own grid holds its map slice, its 5-NN for the whole
  scan is gathered from every rank (distances and neighbour positions, one
  `all_gather`) and merged into the global 5-NN, which feeds the same plane
  fit and gates as the single-device path; each rank then builds the normal
  equations of its scan chunk and one `all_reduce` sums them.
- `make_sharded_knn`: exact k-NN against a sharded point set.

Sharded registration runs the plain PyTorch correspondence search
(`voxel_grid.query_knn` + `registration.fit_planes`), as the JAX package
runs plain XLA there: the global top-5 needs the cross-rank merge before the
plane fit, which the fused kernel does inside itself.  The merge orders
candidates as `jax.lax.top_k` on the negated distances does, ties to the
lower candidate index (`knn._smallest_k`).  The GN loop is the
single-device one (`registration._gn_loop`, the Cholesky step; the JAX
package's sharded loops solve the step by LU); its one host read an
iteration reads a value that came out of the `all_reduce`, the same bits
on every rank, so every rank runs the same number of iterations.
"""

from __future__ import annotations

import torch

from lio_slam_tpu_torch.config import RegistrationConfig
from lio_slam_tpu_torch.ops import knn as knn_mod
from lio_slam_tpu_torch.ops import registration as reg
from lio_slam_tpu_torch.ops import voxel_grid as vg
from lio_slam_tpu_torch.parallel import mesh as mesh_mod
from lio_slam_tpu_torch.utils import se3


def _reduced_terms(scan, corr: reg.Correspondences, pose, mesh, axis):
    """(AtA, Atb, inliers, Σs, Σs|r|) of `corr` summed over the ranks of
    `axis`: the 45 values go in one float32 all_reduce (the inlier count is
    exact in float32 below 2^24)."""
    AtA, Atb = reg._normal_equations(scan, corr, pose)
    flat = torch.cat([AtA.reshape(-1), Atb,
                      torch.stack([torch.sum(corr.valid).to(torch.float32),
                                   torch.sum(corr.weight),
                                   torch.sum(corr.weight
                                             * torch.abs(corr.residual))])])
    flat = mesh_mod.psum(flat, mesh, axis)
    return (flat[:36].reshape(6, 6), flat[36:42], flat[42].to(torch.int32),
            flat[43], flat[44])


def make_sharded_register(mesh, cfg: RegistrationConfig, axis: str = "data",
                          min_correspondences: int = 50):
    """`register(scan_shard, scan_mask_shard, map_pts, map_mask, init_pose)`
    with the scan sharded over `axis` (each rank passes its
    `mesh.shard_points` slice) and the map replicated."""

    def register(scan, scan_mask, map_pts, map_mask, init_pose):
        # the map grid is built once, replicated; each rank queries its
        # scan slice against it
        grid = vg.build_grid(map_pts, map_mask, cfg.nn_radius,
                             cfg.grid_table_size, cfg.grid_max_per_cell,
                             halo=cfg.grid_halo)

        def ne_fn(pose):
            corr = reg.find_correspondences(scan, scan_mask, None, None,
                                            pose, cfg, grid=grid)
            return _reduced_terms(scan, corr, pose, mesh, axis)

        return gn_loop(ne_fn, scan, init_pose, cfg, min_correspondences)

    return register


def gn_loop(ne_fn, scan, init_pose, cfg, min_correspondences):
    """The single-device GN loop (`registration._gn_loop`) on the reduced
    normal equations: every rank reads the same converged flag.  As in the
    JAX package's sharded loops, no minimum-point gate before the first
    iteration (below it fewer than 50 inliers make the step zero)."""
    return reg._gn_loop(scan, None, None, init_pose, cfg, True,
                        min_correspondences, ne_fn=ne_fn)


def merge_topk(dist2: torch.Tensor, payload: torch.Tensor, mesh,
               axis: str, k: int):
    """The global k smallest of every rank's (N, k) `dist2` with their
    (N, k, F) `payload` (one all_gather of both): candidates in rank-major
    order, ties to the lower candidate, as `jax.lax.top_k(-d)` orders
    them.  Returns ((N, k) distances, (N, k, F) payloads)."""
    N = dist2.shape[0]
    both = torch.cat([dist2[..., None], payload], dim=-1)      # (N, k, 1+F)
    allv = mesh_mod.all_gather(both, mesh, axis)               # (D, N, k, 1+F)
    cand = allv.permute(1, 0, 2, 3).reshape(N, -1, both.shape[-1])
    sel = knn_mod._smallest_k(cand[..., 0].contiguous(), k)    # (N, k)
    picked = torch.gather(cand, 1, sel[..., None].expand(N, k, both.shape[-1]))
    return picked[..., 0], picked[..., 1:]


def map_sharded_ne(grid: vg.HashGrid, scan: torch.Tensor,
                   scan_mask: torch.Tensor, cfg: RegistrationConfig, mesh,
                   axis: str = "data", k: int = 5):
    """`ne_fn(pose)` of registration against a map sharded over `axis`:
    `grid` holds this rank's map slice.  The rank's local 5-NN of the whole
    scan, merged across ranks into the global 5-NN (positions carried), the
    plane fit and gates of `find_correspondences`, then the normal
    equations of the rank's contiguous scan chunk, summed over the ranks."""
    N = scan.shape[0]
    D = mesh_mod.axis_size(mesh, axis)
    chunk = N // D
    lo = mesh_mod.axis_index(mesh, axis) * chunk

    def ne_fn(pose):
        R, t = se3.pose6_to_Rt(pose)
        scan_w = se3.transform_points(R, t, scan)
        nn = vg.query_knn(grid, scan_w, scan_mask, k=k, halo=cfg.grid_halo)
        d_loc = torch.where(nn.valid, nn.dist2,
                            torch.full_like(nn.dist2, float("inf")))
        dist2, neighbors = merge_topk(d_loc, nn.neighbors, mesh, axis, k)
        corr = reg.plane_correspondences(scan, scan_mask, scan_w, neighbors,
                                         torch.isfinite(dist2), dist2, cfg)
        corr_c = reg.Correspondences(*[f[lo:lo + chunk] for f in corr])
        return _reduced_terms(scan[lo:lo + chunk], corr_c, pose, mesh, axis)

    return ne_fn


def make_map_sharded_register(mesh, cfg: RegistrationConfig,
                              axis: str = "data",
                              min_correspondences: int = 50, k: int = 5):
    """`register(scan, scan_mask, map_shard, map_mask_shard, init_pose)`
    with the MAP sharded over `axis`: each rank passes the whole scan and
    its `mesh.shard_points` slice of the map, and holds that slice in a grid
    of its own (`cfg.grid_table_size` buckets a rank, so the mesh's total
    capacity is D times one device's).  The scan's size must divide by
    the mesh size."""

    def register(scan, scan_mask, map_shard, map_mask_shard, init_pose):
        if scan.shape[0] % mesh_mod.axis_size(mesh, axis):
            raise ValueError(f"scan of {scan.shape[0]} points does not divide "
                             "by the mesh size")
        grid = vg.build_grid(map_shard, map_mask_shard, cfg.nn_radius,
                             cfg.grid_table_size, cfg.grid_max_per_cell,
                             halo=cfg.grid_halo)
        scan = scan.to(torch.float32)
        ne_fn = map_sharded_ne(grid, scan, scan_mask, cfg, mesh, axis, k)
        return gn_loop(ne_fn, scan, init_pose, cfg, min_correspondences)

    return register


def make_sharded_knn(mesh, k: int = 5, axis: str = "data"):
    """`knn(query, query_mask, map_shard, map_mask_shard) -> (dist2 (N, k),
    idx (N, k))`: each rank's exact k-NN of the whole (replicated) query set
    against its map slice, merged into the global k-NN with indices into
    the global map."""

    def sharded_knn(query, query_mask, map_shard, map_mask_shard):
        local = knn_mod.knn(query, query_mask, map_shard, map_mask_shard, k=k)
        base = mesh_mod.axis_index(mesh, axis) * map_shard.shape[0]
        # the index rides as a float payload: exact below 2^24 points
        gidx = (local.idx + base).to(torch.float32)
        dist2, idx = merge_topk(local.dist2, gidx[..., None], mesh, axis, k)
        return dist2, idx[..., 0].to(torch.int32)

    return sharded_knn
