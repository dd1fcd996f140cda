"""Sharded sparse pose-graph solve (port of `lio_slam_tpu/parallel/sparse.py`):
`graph.sparse.solve_sparse` with the Woodbury correction's columns split
over the ranks, one process per device.

The one heavy part of a loop-closing solve is Y = T⁻¹Aᵀ, K sequential
block solves over the 6L loop columns.  Each rank back-substitutes its
contiguous chunk of the columns and one `all_gather` joins them (over both
axes of a ("slice", "data") mesh, the first the slowest).  Everything else
runs replicated on every rank, by `solve_sparse` itself: the linearization
and block assembly (`sparse._assemble`), the block-tridiagonal
factorization (an O(K) chain of 6x6 blocks), A·Y, the small S solve, the
backtracking step, and the host flags (the active prefix, whether a loop
factor is active), which read the replicated graph, the same on every rank.

The JAX package also shards the assembly (a `psum` of each device's chain
and GPS blocks).  The port does not: the assembly's einsums are cheap next
to the collective that would join them, and a shard's batched
linearization differs in float32 from the whole graph's on the H100 (an
ulp here and there), which the K=2048 loop graph (a translation-soft
prior, a 2 km chain) turns into 1e-2 of its poses.  Replicated, the
assembly has `solve_sparse`'s bits; the column solves have them too.
"""

from __future__ import annotations

import functools

import torch

from lio_slam_tpu_torch.graph import sparse as sp
from lio_slam_tpu_torch.parallel import mesh as mesh_mod


def make_sharded_sparse_solver(mesh, axes=("data",)):
    """`solve(graph, iterations=5, n_active=None) -> SolveResult`: a
    drop-in for `graph.sparse.solve_sparse` with the Woodbury columns
    sharded over the mesh axes (("data",), or ("slice", "data") on a 2-D
    mesh).  Every rank passes the whole (replicated) graph and gets the
    whole result."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n_dev = mesh_mod.flat_size(mesh, axes)
    me = mesh_mod.flat_index(mesh, axes)

    def y_solve(f: sp.TridiagFactor, At: torch.Tensor) -> torch.Tensor:
        """T⁻¹ At (K, 6, M): this rank's column chunk, padded to the same
        width on every rank, then gathered in rank order."""
        K, _, M = At.shape
        mc = -(-M // n_dev)                     # columns a rank
        lo = min(me * mc, M)
        hi = min(lo + mc, M)
        Yc = (sp.tridiag_solve(f, At[:, :, lo:hi].contiguous()) if hi > lo
              else At[:, :, :0])
        Yc = torch.cat([Yc, At.new_zeros((K, 6, mc - (hi - lo)))], dim=-1)
        Y = mesh_mod.all_gather(Yc, mesh, axes)                 # (n, K, 6, mc)
        return Y.permute(1, 2, 0, 3).reshape(K, 6, -1)[:, :, :M]

    return functools.partial(sp.solve_sparse, y_solve=y_solve)
