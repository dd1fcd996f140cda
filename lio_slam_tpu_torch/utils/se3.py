"""SO(3)/SE(3) math on torch tensors, float32-safe and batch-generic.

Port of `lio_slam_tpu/utils/se3.py`, same conventions:
- Euler angles (roll, pitch, yaw) with R = Rz(yaw) @ Ry(pitch) @ Rx(roll)
  (pcl::getTransformation / tf::Matrix3x3::getRPY);
- quaternions are (w, x, y, z);
- pose6 is the reference's transformTobeMapped [roll, pitch, yaw, x, y, z];
- small-angle branches use Taylor series through the double-where pattern,
  so `torch.func.jacfwd` through them stays finite.

The JAX package takes dR/dθ from `jax.jacfwd(rpy_to_matrix)`; here
`rpy_to_matrix_jacobian` gives it in closed form (the fused kernel computes
the same expressions on the device).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# basic helpers
# ---------------------------------------------------------------------------

def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product (hat) matrix. v: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]   # (...,1,1)
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    W = skew(w)
    W2 = W @ W
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    return _eye3(w).expand(W.shape) + a * W + b * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    # thresholds must be representable in float32 (1 - 1e-8 rounds to 1.0)
    near_zero = cos_theta > 1.0 - 1e-6
    near_pi_c = cos_theta < -1.0 + 1e-6
    cos_safe = torch.where(near_zero | near_pi_c,
                           torch.zeros_like(cos_theta), cos_theta)
    theta = torch.where(near_zero, torch.zeros_like(cos_theta),
                        torch.where(near_pi_c,
                                    torch.full_like(cos_theta, math.pi),
                                    torch.acos(cos_safe)))
    v = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    sin_theta = torch.sin(theta)
    near_pi = math.pi - theta < 1e-3
    t2_small = torch.sum(v * v, dim=-1) / 4.0
    sin_safe = torch.where(near_zero | near_pi, torch.ones_like(sin_theta),
                           2.0 * sin_theta)
    scale = torch.where(near_zero, 0.5 + t2_small / 12.0, theta / sin_safe)
    w_generic = scale[..., None] * v
    # near pi: diagonal formula
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp((diag - cos_theta[..., None])
                        / torch.clamp(1.0 - cos_theta[..., None], min=_EPS),
                        min=0.0)
    axis = torch.sqrt(torch.where(near_pi[..., None],
                                  torch.clamp(axis2, min=_EPS),
                                  torch.ones_like(axis2)))
    off = torch.stack([
        R[..., 1, 0] + R[..., 0, 1],
        R[..., 2, 1] + R[..., 1, 2],
        R[..., 0, 2] + R[..., 2, 0],
    ], dim=-1)
    sign = torch.sign(torch.where(torch.abs(v) > 1e-6, v, off))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    w_pi = theta[..., None] * axis * sign
    return torch.where(near_pi[..., None], w_pi, w_generic)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3): exp((w+dw)^) ≈ exp(J_l dw) exp(w^)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    small = theta2 < _EPS
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    W = skew(w)
    W2 = W @ W
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_safe * theta))
    return _eye3(w).expand(W.shape) + b * W + c * W2


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian J_r(w) = J_l(-w)."""
    return so3_left_jacobian(-w)


# ---------------------------------------------------------------------------
# Euler (roll, pitch, yaw)
# ---------------------------------------------------------------------------

def rpy_to_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """(roll, pitch, yaw) (..., 3) -> R = Rz(y) Ry(p) Rx(r) (..., 3, 3)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
        torch.stack([-sp, cp * sr, cp * cr], dim=-1),
    ], dim=-2)


def rpy_to_matrix_jacobian(rpy: torch.Tensor) -> torch.Tensor:
    """Closed-form dR/dθ of `rpy_to_matrix`: (..., 3) -> (..., 3, 3, 3) with
    [..., i, j, k] = dR_ij / dθ_k, θ = (roll, pitch, yaw) — the layout
    `jax.jacfwd(se3.rpy_to_matrix)` returns."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    z = torch.zeros_like(r)
    d_roll = torch.stack([
        torch.stack([z, cy * sp * cr + sy * sr, -cy * sp * sr + sy * cr], dim=-1),
        torch.stack([z, sy * sp * cr - cy * sr, -sy * sp * sr - cy * cr], dim=-1),
        torch.stack([z, cp * cr, -cp * sr], dim=-1),
    ], dim=-2)
    d_pitch = torch.stack([
        torch.stack([-cy * sp, cy * cp * sr, cy * cp * cr], dim=-1),
        torch.stack([-sy * sp, sy * cp * sr, sy * cp * cr], dim=-1),
        torch.stack([-cp, -sp * sr, -sp * cr], dim=-1),
    ], dim=-2)
    d_yaw = torch.stack([
        torch.stack([-sy * cp, -sy * sp * sr - cy * cr, -sy * sp * cr + cy * sr], dim=-1),
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
        torch.stack([z, z, z], dim=-1),
    ], dim=-2)
    return torch.stack([d_roll, d_pitch, d_yaw], dim=-1)


def matrix_to_rpy(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> (roll, pitch, yaw), tf::Matrix3x3::getRPY convention."""
    sp = torch.clamp(-R[..., 2, 0], -1.0, 1.0)
    pitch = torch.asin(sp)
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Shepperd's method, branch-free via where selection."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    s = torch.sqrt(torch.clamp(tr + 1.0, min=_EPS)) * 2
    q0 = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], dim=-1)
    s = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=_EPS)) * 2
    q1 = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s], dim=-1)
    s = torch.sqrt(torch.clamp(1.0 + m11 - m00 - m22, min=_EPS)) * 2
    q2 = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s], dim=-1)
    s = torch.sqrt(torch.clamp(1.0 + m22 - m00 - m11, min=_EPS)) * 2
    q3 = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s], dim=-1)

    use0 = tr > 0
    use1 = (m00 >= m11) & (m00 >= m22)
    use2 = m11 >= m22
    q = torch.where(use0[..., None], q0,
                    torch.where(use1[..., None], q1,
                                torch.where(use2[..., None], q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation (transformUpdate's roll/pitch blend)."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.acos(dot)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-5
    safe = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(small, 1.0 - t + torch.zeros_like(theta),
                     torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(small, t + torch.zeros_like(theta),
                     torch.sin(t * theta) / safe)
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# SE(3) as (R, t) pairs and as 6-vectors
# ---------------------------------------------------------------------------

def se3_exp(xi: torch.Tensor):
    """Twist (..., 6) [w, v] -> (R, t)."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (so3_left_jacobian(w) @ v[..., None])[..., 0]
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    w = so3_log(R)
    Jinv = torch.linalg.inv_ex(so3_left_jacobian(w))[0]
    v = (Jinv @ t[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) ∘ (Rb, tb): x -> Ra (Rb x + tb) + ta."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def transform_points(R: torch.Tensor, t: torch.Tensor,
                     pts: torch.Tensor) -> torch.Tensor:
    """Apply (R, t) to points (..., N, 3)."""
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def pose6_to_Rt(pose6: torch.Tensor):
    return rpy_to_matrix(pose6[..., :3]), pose6[..., 3:]


def Rt_to_pose6(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([matrix_to_rpy(R), t], dim=-1)


def pose6_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    Ra, ta = pose6_to_Rt(a)
    Rb, tb = pose6_to_Rt(b)
    R, t = compose(Ra, ta, Rb, tb)
    return Rt_to_pose6(R, t)


def pose6_inverse(a: torch.Tensor) -> torch.Tensor:
    R, t = pose6_to_Rt(a)
    Ri, ti = inverse(R, t)
    return Rt_to_pose6(Ri, ti)


def pose6_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^{-1} ∘ b (gtsam `between`)."""
    return pose6_compose(pose6_inverse(a), b)
