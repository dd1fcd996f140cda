"""The two-level ("slice", "data") mesh and its staged reduction (port of
`lio_slam_tpu/parallel/multislice.py`), one process per device.

The JAX package's scale-out plan splits a pod two ways: "data" (inside a
slice, the fast links) carries the per-point work, "slice" (across slices,
the slow network) the factors.  A reduction is staged: first over "data",
so each slice's partial is made on its fast links, then over "slice",
which then carries one small tensor a slice.  The port keeps the layout on
a 2-D `DeviceMesh` (`mesh.make_mesh_2d`, rank s * D + d at (s, d)), one
rank a device:

    make_multislice_mesh   -> the ("slice", "data") mesh over the group
    psum_staged            -> an all_reduce over "data", then over "slice"
    shard_factors          -> this rank's rows of P(("slice", "data"))
    make_multislice_solver -> the sharded sparse solver over both axes
    make_multislice_register -> the scan sharded over both axes, the map
                              grid whole on every rank, the terms reduced
                              by `psum_staged`

Settled departure (as the 1-D sharded register, ROADMAP keep-in-view 10):
the register runs the port's GN loop (`registration.gn_loop`: the
Cholesky step, no minimum-point gate before the first iteration), where
the JAX register solves its step by LU; and it returns the loop's inlier
count and mean residual of the last iteration, where the JAX register
returns zeros for both.  Pose, iterations, `degenerate` and `converged`
are what the two compare on.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from lio_slam_tpu_torch.config import RegistrationConfig
from lio_slam_tpu_torch.graph import factors as F
from lio_slam_tpu_torch.parallel import mesh as mesh_mod
from lio_slam_tpu_torch.parallel import registration as preg
from lio_slam_tpu_torch.parallel import sparse as psparse

BOTH = ("slice", "data")


def make_multislice_mesh(n_slices: int, chips_per_slice: int,
                         device_type: str = "cuda"):
    """The (n_slices, chips_per_slice) mesh named ("slice", "data") over
    the whole process group (initialized from torchrun's environment when
    it is not yet).  A group of another size raises ValueError, as the JAX
    package raises when it has too few devices."""
    return mesh_mod.make_mesh_2d(n_slices, chips_per_slice, axes=BOTH,
                                 device_type=device_type)


def psum_staged(x: torch.Tensor, mesh, data_axis: str = "data",
                slice_axis: str = "slice") -> torch.Tensor:
    """The sum of `x` over every rank of the mesh, reduced over
    `data_axis` first and then over `slice_axis`; `x` is not modified.
    Runs inside the "collective:psum" range that `mesh.psum` uses."""
    x = x.clone()
    with torch.profiler.record_function("collective:psum"):
        dist.all_reduce(x, group=mesh.get_group(data_axis))
        dist.all_reduce(x, group=mesh.get_group(slice_axis))
    return x


def shard_factors(mesh, arr: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous rows of `arr`'s axis 0 over the flattened
    ("slice", "data") index, on the rank's device (JAX's
    P(("slice", "data"))).  A size that does not divide raises."""
    return mesh_mod.shard_points(mesh, arr, BOTH).to(
        mesh_mod.mesh_device(mesh))


def make_multislice_solver(mesh):
    """`solve(graph, active_mask, iterations=2) -> PoseGraph`: the sparse
    solve (`graph.sparse.solve_sparse`) with the Woodbury columns split
    over both mesh axes, on the poses of `pose_mask & active_mask`; the
    caller's `pose_mask` comes back on the result.  Every rank passes the
    whole graph and gets the whole result.  The chain layout is required
    (between slots [0, K-1) the odometry chain)."""
    inner = psparse.make_sharded_sparse_solver(mesh, axes=BOTH)

    def solve(graph: F.PoseGraph, active_mask: torch.Tensor,
              iterations: int = 2) -> F.PoseGraph:
        g = graph._replace(pose_mask=graph.pose_mask & active_mask)
        out = inner(g, iterations=iterations).graph
        return out._replace(pose_mask=graph.pose_mask)

    return solve


def make_multislice_register(mesh, cfg: RegistrationConfig,
                             min_correspondences: int = 50):
    """`register(scan_shard, scan_mask_shard, map_pts, map_mask, init_pose)
    -> RegistrationResult` with the scan sharded over both mesh axes (each
    rank passes its `shard_factors` rows) and the map whole on every rank:
    the grid is built at `cfg.grid_halo`, each rank's terms come from
    `registration.find_correspondences` and `_normal_equations` (the plain
    path, as the JAX register runs plain XLA), and `psum_staged` sums
    them.  `num_inliers` and `mean_residual` are the GN loop's (JAX returns
    zeros)."""
    return preg.scan_sharded_register(
        cfg, lambda x: psum_staged(x, mesh), min_correspondences)
