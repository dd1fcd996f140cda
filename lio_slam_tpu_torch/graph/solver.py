"""Gauss-Newton pose-graph solver (port of `lio_slam_tpu/graph/solver.py`,
the reference's iSAM2 as mapOptmization.cpp:2082-2134 uses it).

- `solve_window_compact`: the sliding-window solve, twice per keyframe.
- `solve` / `marginal_covariance`: the dense full-graph solve (x5 after a
  loop or GPS factor, correctPoses :2173-2204) and the pose covariance that
  gates GPS factors (:2128-2133).  They assemble a (K*6)^2 system, so they
  serve capacities up to 512 keyframes; above that `graph/sparse.py` takes
  over (`pipeline/lio._use_sparse_solver`) and these are its yardstick.

Repeated indices are summed with `index_put_(accumulate=True)`, which sorts
the indices on CUDA, so two runs give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lio_slam_tpu_torch.graph import factors as F
from lio_slam_tpu_torch.utils import se3
from lio_slam_tpu_torch.utils.resident import constant


class SolveResult(NamedTuple):
    graph: F.PoseGraph
    delta_norm: torch.Tensor   # () last-iteration update norm
    chi2: torch.Tensor         # () weighted squared error the last step started from


def _weighted_block(J: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """J^T diag(info) J for a batch of factor Jacobians."""
    return torch.einsum("...ri,...r,...rj->...ij", J, info, J)


def _equilibrated_cholesky_solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b in float32: symmetrize, Jacobi-equilibrate
    (D H D, D = diag(H)^{-1/2}), damp by 1e-5, Cholesky-solve."""
    L, Dinv = _scaled_cholesky(H)
    y = torch.cholesky_solve((b * Dinv)[:, None], L)[:, 0]
    return y * Dinv


def _scaled_cholesky(H: torch.Tensor):
    """Lower Cholesky factor of the symmetrized, Jacobi-equilibrated and
    damped H, and the scaling diagonal D^-1/2."""
    H = 0.5 * (H + H.T)
    Dinv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    Hs = H * Dinv[:, None] * Dinv[None, :]
    Hs = Hs + torch.eye(H.shape[0], dtype=H.dtype, device=H.device) * 1e-5
    return torch.linalg.cholesky_ex(Hs)[0], Dinv


def linearize_full(graph: F.PoseGraph, active_mask: torch.Tensor):
    """Dense normal equations H (K6, K6), b (K6,) over the active poses, and
    the weighted squared error chi2 at the linearization point."""
    K = graph.poses.shape[0]
    dtype, dev = graph.poses.dtype, graph.poses.device
    H = torch.zeros((K, K, 6, 6), dtype=dtype, device=dev)
    b = torch.zeros((K, 6), dtype=dtype, device=dev)

    e0, J0 = F.linearize_prior(graph)
    w0 = graph.prior_info
    H[0, 0] += _weighted_block(J0, w0)
    b[0] += -J0.T @ (w0 * e0)

    eb, Ji, Jj = F.linearize_between(graph)
    wb = graph.bt_info * graph.bt_mask[:, None]
    bi, bj = graph.bt_i.long(), graph.bt_j.long()
    H.index_put_((bi, bi), _weighted_block(Ji, wb), accumulate=True)
    H.index_put_((bj, bj), _weighted_block(Jj, wb), accumulate=True)
    Hij = torch.einsum("bri,br,brj->bij", Ji, wb, Jj)
    H.index_put_((bi, bj), Hij, accumulate=True)
    H.index_put_((bj, bi), Hij.transpose(-1, -2), accumulate=True)
    b.index_put_((bi,), -torch.einsum("bri,br,br->bi", Ji, wb, eb),
                 accumulate=True)
    b.index_put_((bj,), -torch.einsum("bri,br,br->bi", Jj, wb, eb),
                 accumulate=True)

    eg, Jg = F.linearize_gps(graph)
    wg = graph.gps_info * graph.gps_mask[:, None]
    gi = graph.gps_i.long()
    H.index_put_((gi, gi), _weighted_block(Jg, wg), accumulate=True)
    b.index_put_((gi,), -torch.einsum("gri,gr,gr->gi", Jg, wg, eg),
                 accumulate=True)

    # inactive poses: zero rows and columns, identity diagonal (H stays SPD)
    act = (active_mask & graph.pose_mask).to(dtype)
    H = H * act[:, None, None, None] * act[None, :, None, None]
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eyeK = torch.eye(K, dtype=dtype, device=dev)[:, :, None, None]
    H = H + torch.einsum("k,ij->kij", 1.0 - act, eye6)[:, None] * eyeK
    H = H + (eyeK * eye6) * 1e-5
    b = b * act[:, None]

    Hd = H.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    chi2 = (torch.sum(wb * eb * eb) + torch.sum(wg * eg * eg)
            + torch.sum(w0 * e0 * e0))
    return Hd, b.reshape(K * 6), chi2


def backtrack_step(g: F.PoseGraph, delta: torch.Tensor,
                   chi2_now: torch.Tensor):
    """Chi2-gated backtracking on a GN step `delta` (K, 6): the scales
    [1, 1/2, 1/4, 1/8] are costed with `F.graph_chi2` and the best is kept
    only if it lowers the cost, so descent is monotone (a raw GN step on a
    loop graph with long lever arms can overshoot and diverge with more
    iterations).  Returns (new_poses, scale_used); nothing here waits for
    the device."""
    R, t = se3.pose6_to_Rt(g.poses)
    scales = constant([1.0, 0.5, 0.25, 0.125], g.poses.dtype, g.poses.device)
    cand = []
    for k in range(scales.shape[0]):
        dR, dt = se3.se3_exp(delta * scales[k])
        cand.append(se3.Rt_to_pose6(*se3.compose(R, t, dR, dt)))
    cand = torch.stack(cand)                                  # (4, K, 6)
    costs = torch.stack([F.graph_chi2(g, p) for p in cand])
    best = torch.argmin(costs)
    improved = costs[best] < chi2_now
    new_poses = torch.where(improved, cand[best], g.poses)
    return new_poses, torch.where(improved, scales[best],
                                  torch.zeros_like(scales[best]))


def solve(graph: F.PoseGraph, active_mask: torch.Tensor,
          iterations: int = 2) -> SolveResult:
    """`iterations` GN steps over the active poses, dense."""
    g = graph
    dtype, dev = graph.poses.dtype, graph.poses.device
    dn = torch.zeros((), dtype=dtype, device=dev)
    chi2 = torch.zeros((), dtype=dtype, device=dev)
    for _ in range(iterations):
        H, b, chi2 = linearize_full(g, active_mask)
        delta = _equilibrated_cholesky_solve(H, b)
        dmat = delta.reshape(g.poses.shape[0], 6)
        dmat = torch.where((active_mask & g.pose_mask)[:, None], dmat,
                           torch.zeros_like(dmat))
        new_poses, scale = backtrack_step(g, dmat, chi2)
        g = g._replace(poses=new_poses)
        dn = torch.linalg.norm(delta) * scale
    return SolveResult(graph=g, delta_norm=dn, chi2=chi2)


def marginal_covariance(graph: F.PoseGraph, idx: torch.Tensor) -> torch.Tensor:
    """(6, 6) marginal covariance of pose `idx`: that block of inv(H), like
    isam->marginalCovariance (mapOptmization.cpp:2128)."""
    K = graph.poses.shape[0]
    H, _, _ = linearize_full(graph, graph.pose_mask)
    L, Dinv = _scaled_cholesky(H)
    rows = torch.as_tensor(idx, device=H.device).long() * 6 \
        + torch.arange(6, device=H.device)
    basis = torch.zeros((K * 6, 6), dtype=H.dtype, device=H.device)
    basis[rows, torch.arange(6, device=H.device)] = 1.0
    cols = Dinv[:, None] * torch.cholesky_solve(basis * Dinv[:, None], L)
    return cols[rows, :]


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
        l0 = l0.reshape(1)      # a 0-dim index would be read back (`at`)
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
