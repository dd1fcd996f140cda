"""Scan-to-map registration (port of `lio_slam_tpu/ops/registration.py`,
mapOptmization.cpp:1618-1897): point-to-plane `register_with_grid` against
the persistent voxel map (the mapping step) and `register` against a map
cloud (loop verification, the rebuild-mode map; a grid built first, or the
brute-force k-NN of `knn_backend="brute"`); the LOAM surface + corner
(point-to-line) registration `register_loam_with_grid` (incremental map)
and `register_loam` (rebuild-mode map).

`lax.while_loop` becomes a host loop with one device-to-host read per GN
iteration (the convergence flag); `register_with_grid(resident=True)` and
`register(resident=True)` run every pass instead, with the iterations
after convergence frozen on the device, and read nothing back.  The
stopping rule is the reference's: |Δrot| < 0.05 deg and |Δtrans| < 0.05
cm, at most 30 iterations, or fewer than 50 correspondences.  With the
fused kernel enabled (the default) each iteration's surface term is one
`fused_corr` pass; `corr_refresh_every > 1` holds the bucket ids computed
at the refresh pose.  The corner term is plain PyTorch (an exact k-NN
among at most a few thousand map corners) and adds no host read.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lio_slam_tpu_torch.config import RegistrationConfig
from lio_slam_tpu_torch.ops import fused_corr
from lio_slam_tpu_torch.ops import knn as knn_mod
from lio_slam_tpu_torch.ops import voxel_grid as vg
from lio_slam_tpu_torch.utils import se3
from lio_slam_tpu_torch.utils import smallmat
from lio_slam_tpu_torch.utils.resident import constant


class Correspondences(NamedTuple):
    normal: torch.Tensor    # (N, 3) plane normals (map frame, unit)
    offset: torch.Tensor    # (N,)   plane offsets d (n·x + d = 0)
    residual: torch.Tensor  # (N,)   signed point-to-plane distance pd2
    weight: torch.Tensor    # (N,)   robust weight s
    valid: torch.Tensor     # (N,)   bool


class RegistrationResult(NamedTuple):
    pose: torch.Tensor          # (6,) refined [roll,pitch,yaw,x,y,z]
    degenerate: torch.Tensor    # () bool — eigenvalue gate fired
    converged: bool             # host value (read every iteration anyway);
    #                             a () bool tensor in the resident form
    iterations: int             # host value; a () int32 tensor in the
    #                             resident form
    num_inliers: torch.Tensor   # () int32 — correspondences in last iteration
    mean_residual: torch.Tensor  # () weighted mean |pd2| of last iteration


def _eigpair_3x3(A: torch.Tensor, which: str):
    """Closed-form eigenpair of batched symmetric 3x3 matrices (Smith's
    trigonometric method + row-cross eigenvector).
    Returns (lam_which (...), lam_mid (...), v (..., 3))."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=1e-20) / 6.0)
    inv_p = 1.0 / p
    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02)) * inv_p * inv_p * inv_p
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min
    lam = lam_min if which == "min" else lam_max
    m = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)      # (..., 3, 3)
    best = torch.sum(cands * cands, dim=-1)
    pick = torch.argmax(best, dim=-1)
    v = torch.gather(cands, -2, pick[..., None, None].expand(
        *pick.shape, 1, 3))[..., 0, :]
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)
    iso = p2 < 1e-12
    z = constant([0.0, 0.0, 1.0], A.dtype, A.device)
    return lam, lam_mid, torch.where(iso[..., None], z, v)


def _largest_eigpair_3x3(A: torch.Tensor):
    return _eigpair_3x3(A, "max")


def fit_planes(neighbors: torch.Tensor, neighbor_valid: torch.Tensor,
               plane_dist_thresh: float):
    """Centroid + covariance smallest-eigenvector plane through k neighbours
    (N, k, 3); returns unit normals (N,3), offsets (N,), valid (N,)."""
    k = neighbors.shape[1]
    centroid = torch.mean(neighbors, dim=1, keepdim=True)
    centered = neighbors - centroid
    cov = torch.einsum("nki,nkj->nij", centered, centered) / k
    _, lam_mid, normal = _eigpair_3x3(cov, "min")
    offset = -torch.einsum("ni,ni->n", normal, centroid[:, 0, :])
    safe = lam_mid > 1e-3
    dist = torch.abs(torch.einsum("nki,ni->nk", neighbors, normal)
                     + offset[:, None])
    plane_ok = torch.all(torch.where(neighbor_valid, dist,
                                     torch.zeros_like(dist))
                         <= plane_dist_thresh, dim=1)
    all_neighbors = (torch.all(neighbor_valid, dim=1)
                     & (torch.sum(neighbor_valid.to(torch.int32), dim=1) == k))
    return normal, offset, safe & plane_ok & all_neighbors


def fit_lines(neighbors: torch.Tensor, neighbor_valid: torch.Tensor,
              line_ratio: float = 3.0):
    """Edge-line fit through k neighbours (N, k, 3): centroid and principal
    covariance direction, valid when the spread is 1-D (lam_max >
    3 lam_mid, upstream LOAM's cornerOptimization criterion).  Returns
    (centroid (N,3), direction (N,3), valid (N,))."""
    k = neighbors.shape[1]
    centroid = torch.mean(neighbors, dim=1, keepdim=True)
    centered = neighbors - centroid
    cov = torch.einsum("nki,nkj->nij", centered, centered) / k
    lam_max, lam_mid, direction = _largest_eigpair_3x3(cov)
    valid = ((lam_max > line_ratio * torch.clamp(lam_mid, min=1e-9))
             & torch.all(neighbor_valid, dim=1))
    return centroid[:, 0, :], direction, valid


def find_line_correspondences(scan: torch.Tensor, scan_mask: torch.Tensor,
                              map_pts: torch.Tensor, map_mask: torch.Tensor,
                              pose6: torch.Tensor, cfg: RegistrationConfig,
                              k: int = 5) -> Correspondences:
    """One cornerOptimization pass (upstream LOAM point-to-line): 5-NN among
    the map's edge points, a line through them, the residual the distance
    to the line; its gradient direction stands as the 'normal', so
    `_normal_equations` applies unchanged."""
    R, t = se3.pose6_to_Rt(pose6)
    scan_w = se3.transform_points(R, t, scan)
    res = knn_mod.knn(scan_w, scan_mask, map_pts, map_mask, k=k)
    neighbors = map_pts[res.idx.to(torch.int64)]            # (N, k, 3)
    nn_ok = res.valid[:, k - 1] & (res.dist2[:, k - 1] < cfg.nn_radius ** 2)
    center, direction, line_ok = fit_lines(neighbors, res.valid)
    rel = scan_w - center
    along = torch.einsum("ni,ni->n", rel, direction)
    perp = rel - along[:, None] * direction                 # residual vector
    ld2 = torch.linalg.norm(perp, dim=-1)
    n = perp / torch.clamp(ld2, min=1e-9)[:, None]          # d(ld2)/d(p_w)
    s = 1.0 - 0.9 * torch.abs(ld2)                          # LOAM corner weight
    valid = scan_mask & nn_ok & line_ok & (s > cfg.robust_weight_floor)
    return Correspondences(normal=n,
                           offset=-torch.einsum("ni,ni->n", n, center),
                           residual=ld2,
                           weight=torch.where(valid, s, torch.zeros_like(s)),
                           valid=valid)


def find_correspondences(scan: torch.Tensor, scan_mask: torch.Tensor,
                         map_pts, map_mask, pose6: torch.Tensor,
                         cfg: RegistrationConfig, k: int = 5,
                         grid: vg.HashGrid = None) -> Correspondences:
    """One surfOptimization pass at the given pose: the 5-NN from `grid`
    when given, else the brute-force k-NN over `map_pts`."""
    R, t = se3.pose6_to_Rt(pose6)
    scan_w = se3.transform_points(R, t, scan)
    if grid is not None:
        nn = vg.query_knn(grid, scan_w, scan_mask, k=k, halo=cfg.grid_halo)
        neighbors, nn_valid, dist2 = nn.neighbors, nn.valid, nn.dist2
    else:
        res = knn_mod.knn(scan_w, scan_mask, map_pts, map_mask, k=k)
        neighbors = map_pts[res.idx.to(torch.int64)]
        nn_valid, dist2 = res.valid, res.dist2
    return plane_correspondences(scan, scan_mask, scan_w, neighbors,
                                 nn_valid, dist2, cfg)


def plane_correspondences(scan: torch.Tensor, scan_mask: torch.Tensor,
                          scan_w: torch.Tensor, neighbors: torch.Tensor,
                          nn_valid: torch.Tensor, dist2: torch.Tensor,
                          cfg: RegistrationConfig) -> Correspondences:
    """The plane fit, gates and weight of `find_correspondences` from the
    scan's k-NN in the map (`neighbors` (N, k, 3), `nn_valid` / `dist2`
    (N, k) in ascending distance), wherever the k-NN came from."""
    k = dist2.shape[1]
    # kd-tree gate: 5th neighbour within nn_radius (pointSearchSqDis[4] < 1.0)
    nn_ok = nn_valid[:, k - 1] & (dist2[:, k - 1] < cfg.nn_radius ** 2)
    normal, offset, plane_ok = fit_planes(neighbors, nn_valid,
                                          cfg.plane_dist_thresh)
    pd2 = torch.einsum("ni,ni->n", normal, scan_w) + offset
    rng = torch.linalg.norm(scan, dim=-1)
    s = 1.0 - 0.9 * torch.abs(pd2) / torch.sqrt(torch.sqrt(
        torch.clamp(rng, min=1e-6)))
    valid = scan_mask & nn_ok & plane_ok & (s > cfg.robust_weight_floor)
    return Correspondences(normal=normal, offset=offset, residual=pd2,
                           weight=torch.where(valid, s, torch.zeros_like(s)),
                           valid=valid)


def _normal_equations(scan: torch.Tensor, corr: Correspondences,
                      pose6: torch.Tensor):
    """6x6 GN system in [roll,pitch,yaw,x,y,z] order: row i is
    s_i [n·(∂R/∂θ_k p), n], rhs −s_i pd2_i."""
    dR = se3.rpy_to_matrix_jacobian(pose6[:3])
    Jrot = torch.einsum("ni,ijk,nj->nk", corr.normal, dR, scan)
    J = torch.cat([Jrot, corr.normal], dim=1)
    w = corr.weight * corr.weight
    AtA = torch.einsum("ni,n,nj->ij", J, w, J)
    Atb = -torch.einsum("ni,n,n->i", J, w, corr.residual)
    return AtA, Atb


def _degeneracy_projection(AtA: torch.Tensor, eig_thresh: float):
    """matP (:1786-1814): P = V diag(eigval >= thresh) Vᵀ."""
    eigval, eigvec = smallmat.eigh_jacobi(AtA)
    keep = (eigval >= eig_thresh).to(AtA.dtype)
    P = (eigvec * keep[None, :]) @ eigvec.T
    return P, torch.any(eigval < eig_thresh)


def _cell_sorted(scan: torch.Tensor, scan_mask: torch.Tensor,
                 cell_size: float):
    """The scan's points in the order of their body-frame cell (masked
    points last), so that neighbouring points read the same buckets; the
    normal equations are a sum over points, so only their rounding
    changes.  Cell coordinates are clipped to 10 bits a axis after adding
    512 and packed (c0 << 20) | (c1 << 10) | c2; a masked point's key is
    1 << 30; the sort is stable, as `jnp.argsort` is."""
    c = torch.clamp(torch.floor(scan / cell_size).to(torch.int32) + 512,
                    0, 1023)
    key = (c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2]
    key = torch.where(scan_mask, key, torch.full_like(key, 1 << 30))
    order = torch.argsort(key, stable=True)
    return scan[order], scan_mask[order]


def _maybe_fused(scan, scan_mask, grid, cfg: RegistrationConfig):
    """The fused-pass ne_fn when enabled (grid backend, use_fused_kernel).
    The wrapper picks the kernel or its plain version by the tensors'
    device.  With corr_refresh_every > 1 returns (bucket_fn,
    from_ids_fn, refresh) and `_gn_loop` holds the bucket ids."""
    if grid is None or not cfg.use_fused_kernel:
        return None
    kw = dict(nn_radius=cfg.nn_radius,
              plane_dist_thresh=cfg.plane_dist_thresh,
              robust_weight_floor=cfg.robust_weight_floor)
    if cfg.corr_refresh_every <= 1:
        def ne_fn(pose):
            return fused_corr.fused_normal_equations(
                grid, scan, scan_mask, pose, halo=cfg.grid_halo, **kw)

        return ne_fn

    def bucket_fn(pose):
        Rm, t = se3.pose6_to_Rt(pose)
        return vg.bucket_ids(se3.transform_points(Rm, t, scan),
                             grid.cell_size, grid.table.shape[0],
                             cfg.grid_halo)

    def from_ids_fn(hh, pose):
        # the grid's own counts: a captured graph reads the buffer the
        # in-graph insert updates
        return fused_corr.fused_ne_from_bucket_ids(
            grid.table, hh, scan, scan_mask, pose, counts=grid.counts, **kw)

    return (bucket_fn, from_ids_fn, int(cfg.corr_refresh_every))


def _gn_pass(scan, corr_fn, ne_fn, it: int, pose, hh, P, degen,
             cfg: RegistrationConfig, min_correspondences: int):
    """GN iteration `it` from `pose`: (pose after the step, held bucket ids,
    P, degen, inliers, mean residual, converged), shared by the host loop
    and the device-resident one.  The bucket ids are refreshed and the
    degeneracy projection computed on the iterations the pass index says,
    as `lax.while_loop`'s body does."""
    if isinstance(ne_fn, tuple):
        bucket_fn, from_ids_fn, refresh = ne_fn
        if it % refresh == 0:
            hh = bucket_fn(pose)
        AtA, Atb, n_inl, w_sum, wres_sum = from_ids_fn(hh, pose)
    elif ne_fn is not None:
        AtA, Atb, n_inl, w_sum, wres_sum = ne_fn(pose)
    else:
        AtA, Atb, n_inl, w_sum, wres_sum = _ne_terms(scan, corr_fn(pose), pose)
    # Levenberg epsilon keeps the solve finite when rank-deficient
    dx = smallmat.cholesky_solve(AtA, Atb, eps=1e-6)
    if it == 0:     # eigendecomposition on the first iteration only
        P, degen = _degeneracy_projection(AtA, cfg.degeneracy_eig_thresh)
    dx = torch.where(degen, P @ dx, dx)
    enough = n_inl >= min_correspondences
    dx = torch.where(enough, dx, torch.zeros_like(dx))
    delta_r_deg = torch.linalg.norm(dx[:3]) * (180.0 / math.pi)
    delta_t_cm = torch.linalg.norm(dx[3:]) * 100.0
    conv = (((delta_r_deg < cfg.rot_converge)
             & (delta_t_cm < cfg.trans_converge)) | ~enough)
    mean_res = wres_sum / torch.clamp(w_sum, min=1e-6)
    return pose + dx, hh, P, degen, n_inl, mean_res, conv


def _gn_start(scan, init_pose6):
    """(pose, P, degen, inliers, mean residual) before the first pass."""
    dev = scan.device
    return (init_pose6.to(torch.float32).clone(),
            torch.eye(6, dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.float32, device=dev))


def _gn_loop(scan, scan_mask, corr_fn, init_pose6, cfg: RegistrationConfig,
             runnable: bool, min_correspondences: int,
             ne_fn=None) -> RegistrationResult:
    """GN iterations until converged (host loop).  `corr_fn(pose)` is the
    unfused path; `ne_fn(pose) -> (AtA, Atb, n_inl, Σs, Σs|pd2|)` the fused
    one, or a (bucket_fn, from_ids_fn, refresh) triple."""
    pose, P, degen, n_inl, mean_res = _gn_start(scan, init_pose6)
    hh = None
    it = 0
    converged = not runnable
    while it < cfg.max_iterations and not converged:
        pose, hh, P, degen, n_inl, mean_res, conv = _gn_pass(
            scan, corr_fn, ne_fn, it, pose, hh, P, degen, cfg,
            min_correspondences)
        it += 1
        converged = bool(conv)          # the iteration's one host read
    return RegistrationResult(pose=pose, degenerate=degen, converged=converged,
                              iterations=it, num_inliers=n_inl,
                              mean_residual=mean_res)


def _gn_loop_resident(scan, scan_mask, corr_fn, init_pose6,
                      cfg: RegistrationConfig, runnable: torch.Tensor,
                      min_correspondences: int,
                      ne_fn=None) -> RegistrationResult:
    """`_gn_loop` with no read of the device: all `cfg.max_iterations`
    passes run, unrolled, and a device flag `active` (the runnable gate,
    then down from the pass that converged) freezes the pose, P, degen,
    inliers, mean residual and the iteration count, which gives
    `lax.while_loop`'s results.  `converged` and `iterations` are device
    tensors here.  The passes after convergence are the price of having no
    conditional: their results are dropped."""
    pose, P, degen, n_inl, mean_res = _gn_start(scan, init_pose6)
    active = runnable.clone()
    iters = torch.zeros((), dtype=torch.int32, device=scan.device)
    hh = None
    for it in range(cfg.max_iterations):
        out = _gn_pass(scan, corr_fn, ne_fn, it, pose, hh, P, degen, cfg,
                       min_correspondences)
        pose, P, degen, n_inl, mean_res = (
            torch.where(active, new, old) for new, old in zip(
                (out[0],) + out[2:6], (pose, P, degen, n_inl, mean_res)))
        hh = out[1]
        iters = iters + active.to(torch.int32)
        active = active & ~out[6]
    return RegistrationResult(pose=pose, degenerate=degen, converged=~active,
                              iterations=iters, num_inliers=n_inl,
                              mean_residual=mean_res)


def register_with_grid(scan: torch.Tensor, scan_mask: torch.Tensor,
                       grid: vg.HashGrid, init_pose6: torch.Tensor,
                       cfg: RegistrationConfig,
                       min_correspondences: int = 50,
                       resident: bool = False) -> RegistrationResult:
    """scan2MapOptimization against the persistent (incremental) voxel map.
    Skips (returns the initial pose) below 31 scan or 51 map points
    (:1841).  `resident` runs `_gn_loop_resident`: no read of the device,
    the same results."""
    scan = scan.to(torch.float32)
    if cfg.sort_scan_by_cell:
        scan, scan_mask = _cell_sorted(scan, scan_mask, cfg.nn_radius)

    def corr_fn(pose):
        return find_correspondences(scan, scan_mask, None, None, pose, cfg,
                                    grid=grid)

    n_scan = torch.sum(scan_mask.to(torch.int32))
    n_map = torch.sum(grid.counts)
    runnable = (n_scan > 30) & (n_map > 50)
    if resident:
        return _gn_loop_resident(scan, scan_mask, corr_fn, init_pose6, cfg,
                                 runnable, min_correspondences,
                                 ne_fn=_maybe_fused(scan, scan_mask, grid, cfg))
    return _gn_loop(scan, scan_mask, corr_fn, init_pose6, cfg, bool(runnable),
                    min_correspondences,
                    ne_fn=_maybe_fused(scan, scan_mask, grid, cfg))


def register(scan: torch.Tensor, scan_mask: torch.Tensor,
             map_pts: torch.Tensor, map_mask: torch.Tensor,
             init_pose6: torch.Tensor, cfg: RegistrationConfig,
             min_correspondences: int = 50,
             resident: bool = False) -> RegistrationResult:
    """scan2MapOptimization against a map cloud: with `knn_backend="grid"`
    a fresh hash grid over `map_pts` (cell size nn_radius, so the queried
    neighbourhood covers the gate) and the fused pass; with "brute" the
    exact k-NN over the cloud at every iteration.  Skips (returns the
    initial pose) below 31 scan or 51 map points (:1841, :1724).
    `resident` runs `_gn_loop_resident`, as `register_with_grid` does: no
    read of the device (the grid is built on the device too), the same
    results."""
    scan = scan.to(torch.float32)
    map_pts = map_pts.to(torch.float32)
    if cfg.sort_scan_by_cell:
        scan, scan_mask = _cell_sorted(scan, scan_mask, cfg.nn_radius)
    grid = _map_grid(map_pts, map_mask, cfg)

    def corr_fn(pose):
        return find_correspondences(scan, scan_mask, map_pts, map_mask, pose,
                                    cfg, grid=grid)

    n_scan = torch.sum(scan_mask.to(torch.int32))
    n_map = torch.sum(map_mask.to(torch.int32))
    runnable = (n_scan > 30) & (n_map > 50)
    ne_fn = _maybe_fused(scan, scan_mask, grid, cfg)
    if resident:
        return _gn_loop_resident(scan, scan_mask, corr_fn, init_pose6, cfg,
                                 runnable, min_correspondences, ne_fn=ne_fn)
    return _gn_loop(scan, scan_mask, corr_fn, init_pose6, cfg, bool(runnable),
                    min_correspondences, ne_fn=ne_fn)


def _map_grid(map_pts, map_mask, cfg: RegistrationConfig):
    """The hash grid over a map cloud for the grid backend, None for the
    brute-force one."""
    if cfg.knn_backend != "grid":
        return None
    return vg.build_grid(map_pts, map_mask, cfg.nn_radius,
                         cfg.grid_table_size, cfg.grid_max_per_cell,
                         halo=cfg.grid_halo)


def _ne_terms(scan, corr: Correspondences, pose):
    """(AtA, Atb, inliers, Σs, Σs|r|) of one term's correspondences."""
    AtA, Atb = _normal_equations(scan, corr, pose)
    return (AtA, Atb, torch.sum(corr.valid).to(torch.int32),
            torch.sum(corr.weight),
            torch.sum(corr.weight * torch.abs(corr.residual)))


def _loam_combined_ne(scan_surf, surf_mask, grid, map_surf, map_surf_mask,
                      scan_corner, corner_mask, map_corner, map_corner_mask,
                      cfg: RegistrationConfig):
    """The ne_fn summing the surface (point-to-plane) and corner
    (point-to-line) terms into one 6x6 GN system an iteration, shared by
    `register_loam` and `register_loam_with_grid`.  With candidate reuse
    (`corr_refresh_every > 1`) the surface term holds its bucket ids
    between refreshes while the corner term is evaluated at every
    iteration; its k-NN launches no kernel."""

    def combine(surf_out, pose):
        corr_c = find_line_correspondences(scan_corner, corner_mask,
                                           map_corner, map_corner_mask,
                                           pose, cfg)
        corner_out = _ne_terms(scan_corner, corr_c, pose)
        return tuple(a + b for a, b in zip(surf_out, corner_out))

    fused = _maybe_fused(scan_surf, surf_mask, grid, cfg)
    if isinstance(fused, tuple):
        bucket_fn, from_ids_fn, refresh = fused
        return (bucket_fn,
                lambda hh, pose: combine(from_ids_fn(hh, pose), pose),
                refresh)
    if fused is not None:
        return lambda pose: combine(fused(pose), pose)

    def surf_unfused(pose):
        corr_s = find_correspondences(scan_surf, surf_mask, map_surf,
                                      map_surf_mask, pose, cfg, grid=grid)
        return _ne_terms(scan_surf, corr_s, pose)

    return lambda pose: combine(surf_unfused(pose), pose)


def register_loam(scan_surf: torch.Tensor, surf_mask: torch.Tensor,
                  map_surf: torch.Tensor, map_surf_mask: torch.Tensor,
                  scan_corner: torch.Tensor, corner_mask: torch.Tensor,
                  map_corner: torch.Tensor, map_corner_mask: torch.Tensor,
                  init_pose6: torch.Tensor, cfg: RegistrationConfig,
                  min_correspondences: int = 50) -> RegistrationResult:
    """LOAM registration against map clouds (the rebuild-mode local map):
    point-to-plane (surface) plus point-to-line (corner) terms summed into
    one 6x6 GN system an iteration; the surface grid is built here."""
    scan_surf = scan_surf.to(torch.float32)
    map_surf = map_surf.to(torch.float32)
    scan_corner = scan_corner.to(torch.float32)
    map_corner = map_corner.to(torch.float32)
    grid = _map_grid(map_surf, map_surf_mask, cfg)
    ne_fn = _loam_combined_ne(scan_surf, surf_mask, grid,
                              map_surf, map_surf_mask,
                              scan_corner, corner_mask,
                              map_corner, map_corner_mask, cfg)
    n_scan = (torch.sum(surf_mask.to(torch.int32))
              + torch.sum(corner_mask.to(torch.int32)))
    n_map = (torch.sum(map_surf_mask.to(torch.int32))
             + torch.sum(map_corner_mask.to(torch.int32)))
    runnable = bool((n_scan > 30) & (n_map > 50))
    return _gn_loop(scan_surf, surf_mask, None, init_pose6, cfg, runnable,
                    min_correspondences, ne_fn=ne_fn)


def register_loam_with_grid(scan_surf: torch.Tensor, surf_mask: torch.Tensor,
                            grid: vg.HashGrid,
                            scan_corner: torch.Tensor, corner_mask: torch.Tensor,
                            map_corner: torch.Tensor,
                            map_corner_mask: torch.Tensor,
                            init_pose6: torch.Tensor, cfg: RegistrationConfig,
                            min_correspondences: int = 50) -> RegistrationResult:
    """LOAM surface + corner registration against the persistent
    incremental surface map and a flat corner map cloud (no grid: corner
    counts are small enough for the exact k-NN)."""
    scan_surf = scan_surf.to(torch.float32)
    scan_corner = scan_corner.to(torch.float32)
    map_corner = map_corner.to(torch.float32)
    ne_fn = _loam_combined_ne(scan_surf, surf_mask, grid, None, None,
                              scan_corner, corner_mask,
                              map_corner, map_corner_mask, cfg)
    n_scan = (torch.sum(surf_mask.to(torch.int32))
              + torch.sum(corner_mask.to(torch.int32)))
    n_map = torch.sum(grid.counts)
    runnable = bool((n_scan > 30) & (n_map > 50))
    return _gn_loop(scan_surf, surf_mask, None, init_pose6, cfg, runnable,
                    min_correspondences, ne_fn=ne_fn)


def transform_update(pose6: torch.Tensor, imu_rpy: torch.Tensor,
                     imu_available: torch.Tensor, imu_rpy_weight: float,
                     rotation_tolerance: float = 1000.0,
                     z_tolerance: float = 1000.0) -> torch.Tensor:
    """Slerp roll/pitch toward the IMU attitude and clamp (transformUpdate,
    mapOptmization.cpp:1867-1897)."""
    zero = torch.zeros_like(pose6[0])

    def blend(angle, target):
        q0 = se3.matrix_to_quat(se3.rpy_to_matrix(torch.stack([angle, zero, zero])))
        q1 = se3.matrix_to_quat(se3.rpy_to_matrix(torch.stack([target, zero, zero])))
        q = se3.slerp(q0, q1, imu_rpy_weight)
        return se3.matrix_to_rpy(se3.quat_to_matrix(q))[0]

    roll = torch.where(imu_available, blend(pose6[0], imu_rpy[0]), pose6[0])
    pitch = torch.where(imu_available, blend(pose6[1], imu_rpy[1]), pose6[1])
    roll = torch.clamp(roll, -rotation_tolerance, rotation_tolerance)
    pitch = torch.clamp(pitch, -rotation_tolerance, rotation_tolerance)
    z = torch.clamp(pose6[5], -z_tolerance, z_tolerance)
    return torch.stack([roll, pitch, pose6[2], pose6[3], pose6[4], z])
