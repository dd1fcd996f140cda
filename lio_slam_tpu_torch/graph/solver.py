"""Sliding-window Gauss-Newton pose-graph solve (port of the window part of
`lio_slam_tpu/graph/solver.py`, the reference's iSAM2 update x2 per
keyframe, mapOptmization.cpp:2082-2092).

The full-graph `solve` / `marginal_covariance` and the sparse backend
(`graph/sparse.py`) serve loop and GPS corrections, which the port does not
run yet.
"""

from __future__ import annotations

import torch

from lio_slam_tpu_torch.graph import factors as F
from lio_slam_tpu_torch.utils import se3


def _weighted_block(J: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """J^T diag(info) J for a batch of factor Jacobians."""
    return torch.einsum("...ri,...r,...rj->...ij", J, info, J)


def _equilibrated_cholesky_solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b in float32: symmetrize, Jacobi-equilibrate
    (D H D, D = diag(H)^{-1/2}), damp by 1e-5, Cholesky-solve."""
    H = 0.5 * (H + H.T)
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Dinv = 1.0 / d
    Hs = H * Dinv[:, None] * Dinv[None, :]
    Hs = Hs + torch.eye(H.shape[0], dtype=H.dtype, device=H.device) * 1e-5
    L = torch.linalg.cholesky_ex(Hs)[0]
    y = torch.cholesky_solve((b * Dinv)[:, None], L)[:, 0]
    return y * Dinv


def solve_window_compact(graph: F.PoseGraph, count: torch.Tensor,
                         window: int, iterations: int = 2) -> F.PoseGraph:
    """Fixed-lag GN over the last `window` keyframes: every factor touching
    them enters a compact (window*6)^2 system; poses outside the window are
    held fixed (their side contributes error but no Jacobian block)."""
    W = window
    dev = graph.poses.device
    start = torch.clamp(count - W, min=0)
    g_idx = (start + torch.arange(W, device=dev)).to(torch.int64)
    slot_ok = g_idx < count
    g_idx_c = torch.clamp(g_idx, max=graph.poses.shape[0] - 1)

    def local_of(gl):
        return gl.to(torch.int64) - start

    g = graph
    for _ in range(iterations):
        dtype = g.poses.dtype
        H = torch.zeros((W + 1, W + 1, 6, 6), dtype=dtype, device=dev)
        b = torch.zeros((W + 1, 6), dtype=dtype, device=dev)

        e0, J0 = F.linearize_prior(g)
        l0 = local_of(torch.zeros((), dtype=torch.int64, device=dev))
        l0 = torch.where((l0 >= 0) & (l0 < W), l0, torch.full_like(l0, W))
        w0 = g.prior_info
        H[l0, l0] += _weighted_block(J0, w0)
        b[l0] += -J0.T @ (w0 * e0)

        eb, Ji, Jj = F.linearize_between(g)
        li, lj = local_of(g.bt_i), local_of(g.bt_j)
        in_i = (li >= 0) & (li < W) & g.bt_mask
        in_j = (lj >= 0) & (lj < W) & g.bt_mask
        li = torch.where(in_i, li, torch.full_like(li, W))
        lj = torch.where(in_j, lj, torch.full_like(lj, W))
        wb = g.bt_info * g.bt_mask[:, None]
        wb_i = wb * in_i[:, None]
        wb_j = wb * in_j[:, None]
        H.index_put_((li, li), _weighted_block(Ji, wb_i), accumulate=True)
        H.index_put_((lj, lj), _weighted_block(Jj, wb_j), accumulate=True)
        Hij = torch.einsum("bri,br,brj->bij", Ji, wb * (in_i & in_j)[:, None], Jj)
        H.index_put_((li, lj), Hij, accumulate=True)
        H.index_put_((lj, li), Hij.transpose(-1, -2), accumulate=True)
        b.index_put_((li,), -torch.einsum("bri,br,br->bi", Ji, wb_i, eb),
                     accumulate=True)
        b.index_put_((lj,), -torch.einsum("bri,br,br->bi", Jj, wb_j, eb),
                     accumulate=True)

        eg, Jg = F.linearize_gps(g)
        lg = local_of(g.gps_i)
        in_g = (lg >= 0) & (lg < W) & g.gps_mask
        lg = torch.where(in_g, lg, torch.full_like(lg, W))
        wg = g.gps_info * in_g[:, None]
        H.index_put_((lg, lg), _weighted_block(Jg, wg), accumulate=True)
        b.index_put_((lg,), -torch.einsum("gri,gr,gr->gi", Jg, wg, eg),
                     accumulate=True)

        H = H[:W, :W]
        b = b[:W]
        act = slot_ok.to(dtype)
        H = H * act[:, None, None, None] * act[None, :, None, None]
        eye6 = torch.eye(6, dtype=dtype, device=dev)
        H = H + torch.einsum("k,ij->kij", 1.0 - act, eye6)[:, None] * \
            torch.eye(W, dtype=dtype, device=dev)[:, :, None, None]
        Hd = H.permute(0, 2, 1, 3).reshape(W * 6, W * 6)
        bd = (b * act[:, None]).reshape(W * 6)

        delta = _equilibrated_cholesky_solve(Hd, bd).reshape(W, 6)
        delta = torch.where(slot_ok[:, None], delta, torch.zeros_like(delta))

        R, t = se3.pose6_to_Rt(g.poses[g_idx_c])
        dR, dt = se3.se3_exp(delta)
        Rn, tn = se3.compose(R, t, dR, dt)
        upd = torch.where(slot_ok[:, None], se3.Rt_to_pose6(Rn, tn),
                          g.poses[g_idx_c])
        poses = g.poses.clone()
        if W <= poses.shape[0]:
            poses[g_idx_c] = upd        # idle slots write their old value
        else:
            # a window wider than the store clamps slots onto one row
            poses[g_idx_c[slot_ok]] = upd[slot_ok]
        g = g._replace(poses=poses)
    return g


def window_mask(pose_mask: torch.Tensor, num_keyframes: torch.Tensor,
                window: int) -> torch.Tensor:
    """Mask of the last `window` active keyframes."""
    idx = torch.arange(pose_mask.shape[0], device=pose_mask.device)
    return pose_mask & (idx >= torch.clamp(num_keyframes - window, min=0))
