"""The plain reference that decides `correct`: LIO-SAM's scan prep,
point-to-plane registration, keyframe gate and loop verification, written
out again in plain torch.  It imports nothing of the program.

It follows the program step by step: the map a scan is registered
against is made here from the generated scans of the keyframes the
program saved, placed at the poses the program published for them (after
each full correction, at the corrected poses).  Everything else is worked
out here from the generated inputs: deskew from the gyro, range and box
filters, ring decimation, voxel centroids, exact 5-NN, plane fits, robust
weights and Gauss-Newton to convergence.

`Precision` sets where numbers are rounded: "float64" (the reference)
rounds nowhere; the controls ("tf32", "bf16") round the operands of every
product (points, rotations, Jacobians, residuals) to TF32's or
bfloat16's mantissa, and "bf16" also every stored cloud, map and pose.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

F64 = torch.float64


def _round_mantissa(bits: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """Round a float64 tensor to `bits` explicit mantissa bits (nearest,
    ties away), returned as float64."""
    def rnd(x: torch.Tensor) -> torch.Tensor:
        m, e = torch.frexp(x)
        scale = float(2 ** (bits + 1))
        return torch.ldexp(torch.round(m * scale) / scale, e)
    return rnd


class Precision(NamedTuple):
    name: str
    product: Callable          # operands of products and sums of products
    store: Callable            # clouds, maps and poses as they are kept


def precision(name: str) -> Precision:
    ident = lambda x: x
    if name == "float64":
        return Precision(name, ident, ident)
    if name == "tf32":
        return Precision(name, _round_mantissa(10), ident)
    if name == "bf16":
        r = _round_mantissa(7)
        return Precision(name, r, r)
    raise ValueError(f"unknown precision {name!r}")


# -- rotations --------------------------------------------------------------

def rpy_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """R = Rz(yaw) Ry(pitch) Rx(roll), the pose6 convention of LIO-SAM's
    transformTobeMapped (roll, pitch, yaw, x, y, z)."""
    r, p, y = rpy.unbind(-1)
    cr, sr, cp, sp, cy, sy = (torch.cos(r), torch.sin(r), torch.cos(p),
                              torch.sin(p), torch.cos(y), torch.sin(y))
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        torch.stack([-sp, cp * sr, cp * cr], -1)], -2)


def matrix_rpy(R: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.atan2(R[..., 2, 1], R[..., 2, 2]),
                        torch.asin((-R[..., 2, 0]).clamp(-1, 1)),
                        torch.atan2(R[..., 1, 0], R[..., 0, 0])], -1)


def pose_matrix(pose6: torch.Tensor) -> torch.Tensor:
    """(..., 6) pose6 -> (..., 4, 4) float64."""
    pose6 = pose6.to(F64)
    T = torch.zeros(pose6.shape[:-1] + (4, 4), dtype=F64, device=pose6.device)
    T[..., :3, :3] = rpy_matrix(pose6[..., :3])
    T[..., :3, 3] = pose6[..., 3:]
    T[..., 3, 3] = 1.0
    return T


def inverse(T: torch.Tensor) -> torch.Tensor:
    Ti = torch.zeros_like(T)
    Rt = T[..., :3, :3].transpose(-1, -2)
    Ti[..., :3, :3] = Rt
    Ti[..., :3, 3] = -(Rt @ T[..., :3, 3, None])[..., 0]
    Ti[..., 3, 3] = 1.0
    return Ti


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    th = torch.linalg.norm(w, dim=-1, keepdim=True)[..., None]
    K = torch.zeros(w.shape[:-1] + (3, 3), dtype=w.dtype, device=w.device)
    K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = -w[..., 2], w[..., 1], -w[..., 0]
    K = K - K.transpose(-1, -2)
    small = th < 1e-8
    a = torch.where(small, 1.0 - th * th / 6.0, torch.sin(th) / th.clamp(min=1e-30))
    b = torch.where(small, 0.5 - th * th / 24.0,
                    (1.0 - torch.cos(th)) / (th * th).clamp(min=1e-60))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    cos = ((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5).clamp(-1, 1)
    th = torch.acos(cos)
    k = torch.where(th < 1e-9, torch.full_like(th, 0.5),
                    th / (2.0 * torch.sin(th).clamp(min=1e-30)))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    return v * k[..., None]


def pose_gap(A: torch.Tensor, B: torch.Tensor):
    """(translation m, rotation deg) between two (4, 4) poses."""
    D = inverse(A) @ B
    return (float(torch.linalg.norm(A[:3, 3] - B[:3, 3])),
            math.degrees(float(torch.linalg.norm(so3_log(D[:3, :3])))))


# -- scan prep ----------------------------------------------------------------

def deskew(xyz, ptime, gyr, rel_t, imask):
    """Points into the sweep-start frame: the gyro integrated sample by
    sample (R_k = R_{k-1} exp(w_k dt_k), dt from the sample times), the
    rotation vector interpolated linearly at each point's time, p' =
    R(0)^T R(t) p (imageProjection.cpp:359-575)."""
    times = rel_t.to(F64)
    valid = imask
    dt = torch.diff(times, prepend=times[:1]).clamp(min=0.0)
    dt = torch.where(valid, dt, torch.zeros_like(dt))
    steps = so3_exp(gyr.to(F64) * dt[:, None])
    cum = torch.empty_like(steps)
    acc = torch.eye(3, dtype=F64, device=xyz.device)
    for k in range(steps.shape[0]):
        acc = acc @ steps[k]
        cum[k] = acc
    rv = so3_log(cum)
    tt = torch.where(valid, times, torch.full_like(times, float("inf")))
    n_valid = int(valid.sum())

    def rot_at(t):
        hi = (t[:, None] >= tt[None, :]).sum(1)
        hi = hi.clamp(min=1, max=max(n_valid - 1, 1))
        lo = hi - 1
        a = ((t - times[lo]) / (times[hi] - times[lo]).clamp(min=1e-9)).clamp(0, 1)
        return so3_exp(rv[lo] * (1 - a[:, None]) + rv[hi] * a[:, None])

    pt = ptime.to(F64)
    R0 = rot_at(torch.zeros(1, dtype=F64, device=xyz.device))[0]
    p = (rot_at(pt) @ xyz.to(F64)[:, :, None])[:, :, 0]
    return p @ R0


def voxel_centroids(pts: torch.Tensor, leaf: float) -> torch.Tensor:
    """The centroid of the points of each occupied `leaf` voxel."""
    if pts.shape[0] == 0:
        return pts
    key = torch.floor(pts / leaf).to(torch.int64)
    key = key - key.min(0).values
    span = key.max(0).values + 1
    flat = (key[:, 0] * span[1] + key[:, 1]) * span[2] + key[:, 2]
    _, inv = torch.unique(flat, return_inverse=True)
    n = int(inv.max()) + 1
    sums = torch.zeros((n, 3), dtype=pts.dtype, device=pts.device)
    sums.index_add_(0, inv, pts)
    cnt = torch.zeros(n, dtype=pts.dtype, device=pts.device)
    cnt.index_add_(0, inv, torch.ones_like(pts[:, 0]))
    return sums / cnt[:, None]


def prep_scan(params: dict, xyz, ptime, ring, gyr, rel_t, imask,
              prec: Precision) -> torch.Tensor:
    """A raw scan as the mapping step registers it: deskewed (where the
    IMU window has samples), range- and box-filtered, ring- and
    point-decimated, voxel-downsampled at the surface leaf.  (n, 3)
    float64 in the body frame."""
    p = deskew(xyz, ptime, gyr, rel_t, imask) if bool(imask.any()) else xyz.to(F64)
    r = torch.linalg.norm(p, dim=1)
    keep = (r >= params["lidar_min_range"]) & (r <= params["lidar_max_range"])
    lo = torch.tensor(params["crop_box_min"], dtype=F64, device=p.device)
    hi = torch.tensor(params["crop_box_max"], dtype=F64, device=p.device)
    keep &= ~((p >= lo) & (p <= hi)).all(1)
    idx = torch.arange(p.shape[0], device=p.device)
    keep &= idx % params["point_filter_num"] == 0
    if params["downsample_rate"] > 1:
        keep &= ring % params["downsample_rate"] == 0
    return prec.store(voxel_centroids(p[keep], params["surf_leaf"]))


# -- registration -------------------------------------------------------------

def knn5(q: torch.Tensor, m: torch.Tensor, radius: float, block: int = 1024):
    """(squared distances (n, 5), indices (n, 5)) of the five nearest map
    points of each query, exact wherever the fifth lies within `radius`
    (elsewhere the distances may read larger, or inf, which the caller's
    radius test rejects alike).  Queries go in blocks of neighbouring
    points, each against the map points inside the block's box grown by
    `radius`: every neighbour within `radius` of a query is in that box."""
    n = q.shape[0]
    d_out = torch.full((n, 5), float("inf"), dtype=q.dtype, device=q.device)
    i_out = torch.zeros((n, 5), dtype=torch.int64, device=q.device)
    cell = torch.floor(q[:, :2] / 4.0).to(torch.int64)
    cell = cell - cell.min(0).values
    order = torch.argsort(cell[:, 0] * (int(cell[:, 1].max()) + 1) + cell[:, 1])
    for s in range(0, n, block):
        idx = order[s:s + block]
        qb = q[idx]
        lo, hi = qb.min(0).values - radius, qb.max(0).values + radius
        near = torch.nonzero(((m >= lo) & (m <= hi)).all(1)).flatten()
        if near.numel() < 5:
            continue
        mb = m[near]
        d2 = ((qb * qb).sum(1)[:, None] + (mb * mb).sum(1)[None, :]
              - 2.0 * (qb @ mb.T))
        d, i = torch.topk(d2, 5, dim=1, largest=False)
        d_out[idx] = d.clamp(min=0)
        i_out[idx] = near[i]
    return d_out, i_out


def register(params: dict, scan: torch.Tensor, map_pts: torch.Tensor,
             T0: torch.Tensor, prec: Precision, max_iters: int = None):
    """Point-to-plane Gauss-Newton of `scan` (body, (n, 3)) onto `map_pts`
    (world, (m, 3)) from `T0` (4, 4), LIO-SAM's surfOptimization: the five
    nearest map points within `nn_radius`, a plane fit to them valid where
    each lies within `plane_dist_thresh` of it, robust weight s = 1 - 0.9
    |d| / sqrt(|p|) kept above `robust_weight_floor`; steps until one is
    under `rot_converge` deg and `trans_converge` cm.  Returns (T, passes,
    points used at the last pass)."""
    dev = scan.device
    q, st = prec.product, prec.store
    # world coordinates are kept (and rounded) as they are; the products
    # work near the scan, about `center`
    center = T0[:3, 3].clone()
    m = st(map_pts.to(F64)) - center
    R = T0[:3, :3].clone()
    t = st(T0[:3, 3]) - center
    sq_range = torch.sqrt(torch.linalg.norm(scan, dim=1))
    ones = torch.ones((scan.shape[0], 5, 1), dtype=F64, device=dev)
    passes, used = 0, 0
    for passes in range(1, (max_iters or params["max_iterations"]) + 1):
        pw = q(scan) @ q(R).T + t
        d2, nn = knn5(pw, m, params["nn_radius"])
        nb = m[nn]                                          # (n, 5, 3)
        near = d2[:, 4] < params["nn_radius"] ** 2
        x = torch.linalg.lstsq(q(nb), -ones).solution[:, :, 0]
        inv_norm = 1.0 / torch.linalg.norm(x, dim=1).clamp(min=1e-12)
        nrm = x * inv_norm[:, None]
        dist = inv_norm
        fit = ((nb * nrm[:, None, :]).sum(2) + dist[:, None]).abs()
        ok = near & (fit <= params["plane_dist_thresh"]).all(1)
        pd = (pw * nrm).sum(1) + dist
        s = 1.0 - 0.9 * pd.abs() / sq_range
        ok &= s > params["robust_weight_floor"]
        used = int(ok.sum())
        if used < params["min_surf_points"]:
            break
        J = torch.cat([torch.cross(pw, nrm, dim=1), nrm], 1)[ok] * s[ok, None]
        r = (pd * s)[ok]
        J, r = q(J), q(r)
        H = J.T @ J
        g = J.T @ r
        delta = -torch.linalg.solve(H, g)
        dR = so3_exp(delta[:3])
        R = st(dR @ R)
        t = st(dR @ t + delta[3:] + center) - center
        if (math.degrees(float(torch.linalg.norm(delta[:3]))) < params["rot_converge"]
                and float(torch.linalg.norm(delta[3:])) * 100.0 < params["trans_converge"]):
            break
    T = torch.eye(4, dtype=F64, device=dev)
    T[:3, :3] = R
    T[:3, 3] = t + center
    return T, passes, used


# -- keyframe gate ------------------------------------------------------------

def keyframe_due(params: dict, last: torch.Tensor, pose: torch.Tensor,
                 margin: float = 1e-4):
    """saveFrame's gate of `pose` against the last keyframe's `last`:
    True / False, or None where a threshold lies within `margin` of the
    motion (a float32 program may round either way there)."""
    D = inverse(last) @ pose
    ang = matrix_rpy(D[:3, :3]).abs()
    dist = float(torch.linalg.norm(D[:3, 3]))
    a_th, d_th = params["angle_threshold"], params["dist_threshold"]
    if abs(dist - d_th) < margin or bool(((ang - a_th).abs() < margin).any()):
        return None
    return bool((ang >= a_th).any()) or dist >= d_th
