"""Sharded pose-graph solve with the dense solver's surface (port of
`lio_slam_tpu/parallel/graph.py`).

`make_sharded_solver(mesh)` returns `solve(graph, active_mask, iterations)
-> PoseGraph`, the surface of `graph.solver.solve(...).graph`, over the
column-sharded sparse solver (`parallel/sparse.py`): `solve_sparse` with
the Woodbury loop correction's columns split over the mesh.  Layout as `graph/sparse.py` requires: between
slots [0, K-1) are the odometry chain (slot i couples i -> i+1), slots
>= K-1 are loop closures.
"""

from __future__ import annotations

import torch

from lio_slam_tpu_torch.graph import factors as F
from lio_slam_tpu_torch.parallel.sparse import make_sharded_sparse_solver


def make_sharded_solver(mesh, axis: str = "data"):
    """`solve(graph, active_mask, iterations=2) -> PoseGraph` with the
    Woodbury columns sharded over `axis`."""
    inner = make_sharded_sparse_solver(mesh, axes=(axis,))

    def solve(graph: F.PoseGraph, active_mask: torch.Tensor,
              iterations: int = 2) -> F.PoseGraph:
        g = graph._replace(pose_mask=graph.pose_mask & active_mask)
        out = inner(g, iterations=iterations).graph
        return out._replace(pose_mask=graph.pose_mask)

    return solve
