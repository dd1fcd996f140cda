"""Factor definitions for the keyframe pose graph (port of
`lio_slam_tpu/graph/factors.py`, mapOptmization.cpp:1930-2062).

gtsam conventions: tangent order (rotation, translation); between error
Log(M^{-1} X_i^{-1} X_j); poses retract on the right, X <- X · Exp(delta).
The Jacobians at delta = 0 come from `torch.func.jacfwd`, as the JAX
package takes them from `jax.jacfwd`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from lio_slam_tpu_torch.utils import se3


class PoseGraph(NamedTuple):
    """Fixed-capacity factor graph over keyframe poses (K keyframes, B
    between factors, G GPS factors)."""

    poses: torch.Tensor        # (K, 6) pose6
    pose_mask: torch.Tensor    # (K,) bool
    prior_pose: torch.Tensor   # (6,)
    prior_info: torch.Tensor   # (6,) information diag (rot, trans)
    bt_i: torch.Tensor         # (B,) int32
    bt_j: torch.Tensor         # (B,) int32
    bt_meas: torch.Tensor      # (B, 6)
    bt_info: torch.Tensor      # (B, 6)
    bt_mask: torch.Tensor      # (B,) bool
    gps_i: torch.Tensor        # (G,) int32
    gps_meas: torch.Tensor     # (G, 3)
    gps_info: torch.Tensor     # (G, 3)
    gps_mask: torch.Tensor     # (G,) bool


def empty_graph(max_keyframes: int, max_between: int, max_gps: int,
                device=None) -> PoseGraph:
    K, B, G = max_keyframes, max_between, max_gps
    f32, i32, b = torch.float32, torch.int32, torch.bool
    z = lambda *s, dt=f32: torch.zeros(s, dtype=dt, device=device)
    return PoseGraph(
        poses=z(K, 6), pose_mask=z(K, dt=b),
        prior_pose=z(6), prior_info=z(6),
        bt_i=z(B, dt=i32), bt_j=z(B, dt=i32), bt_meas=z(B, 6),
        bt_info=z(B, 6), bt_mask=z(B, dt=b),
        gps_i=z(G, dt=i32), gps_meas=z(G, 3), gps_info=z(G, 3),
        gps_mask=z(G, dt=b))


# ---------------------------------------------------------------------------
# error functions
# ---------------------------------------------------------------------------

def _retract(pose6, delta):
    R, t = se3.pose6_to_Rt(pose6)
    dR, dt = se3.se3_exp(delta)
    return se3.compose(R, t, dR, dt)


def prior_error(pose6, delta, meas6):
    """Log(M^{-1} · X·Exp(d)) in (rot, trans) order."""
    R, t = _retract(pose6, delta)
    Rm, tm = se3.pose6_to_Rt(meas6)
    Rmi, tmi = se3.inverse(Rm, tm)
    Re, te = se3.compose(Rmi, tmi, R, t)
    return se3.se3_log(Re, te)


def between_error(pose_i, pose_j, delta_i, delta_j, meas6):
    """Log(M^{-1} · (X_i Exp(d_i))^{-1} (X_j Exp(d_j)))."""
    Ri, ti = _retract(pose_i, delta_i)
    Rj, tj = _retract(pose_j, delta_j)
    Rii, tii = se3.inverse(Ri, ti)
    Rij, tij = se3.compose(Rii, tii, Rj, tj)
    Rm, tm = se3.pose6_to_Rt(meas6)
    Rmi, tmi = se3.inverse(Rm, tm)
    Re, te = se3.compose(Rmi, tmi, Rij, tij)
    return se3.se3_log(Re, te)


def gps_error(pose_i, delta_i, meas3):
    """Translation of the retracted pose minus the GPS ENU position."""
    _, t = _retract(pose_i, delta_i)
    return t - meas3


def _unit_batched(fn):
    """`fn` evaluated with a leading batch dim of 1.  Under forward-mode AD
    a 0-dim float32 tensor combined with a Python float gets a float64
    tangent (torch.func), which then breaks the float32 matmuls; with the
    extra dim no intermediate is 0-dim."""
    def wrapped(*args):
        return fn(*(a[None] for a in args))[0]
    return wrapped


_prior_jac = jacfwd(_unit_batched(prior_error), argnums=1)
_between_jac_i = jacfwd(_unit_batched(between_error), argnums=2)
_between_jac_j = jacfwd(_unit_batched(between_error), argnums=3)
_gps_jac = jacfwd(_unit_batched(gps_error), argnums=1)


def _z6(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(6, dtype=like.dtype, device=like.device)


def _one_between(pose_i, pose_j, meas):
    z = _z6(pose_i)
    return (between_error(pose_i, pose_j, z, z, meas),
            _between_jac_i(pose_i, pose_j, z, z, meas),
            _between_jac_j(pose_i, pose_j, z, z, meas))


def _one_gps(pose_i, meas):
    z = _z6(pose_i)
    return gps_error(pose_i, z, meas), _gps_jac(pose_i, z, meas)


def linearize_prior(graph: PoseGraph):
    z = _z6(graph.poses)
    return (prior_error(graph.poses[0], z, graph.prior_pose),
            _prior_jac(graph.poses[0], z, graph.prior_pose))


def linearize_between(graph: PoseGraph):
    """(e (B,6), Ji (B,6,6), Jj (B,6,6)) of every between factor slot."""
    return vmap(_one_between)(graph.poses[graph.bt_i.long()],
                              graph.poses[graph.bt_j.long()], graph.bt_meas)


def linearize_gps(graph: PoseGraph):
    return vmap(_one_gps)(graph.poses[graph.gps_i.long()], graph.gps_meas)


def graph_chi2(graph: PoseGraph, poses: torch.Tensor = None) -> torch.Tensor:
    """Total weighted squared error of all active factors at `poses`."""
    if poses is None:
        poses = graph.poses
    z = _z6(poses)
    e0 = prior_error(poses[0], z, graph.prior_pose)
    chi2 = torch.sum(graph.prior_info * e0 * e0)
    eb = vmap(lambda pi, pj, m: between_error(pi, pj, z, z, m))(
        poses[graph.bt_i.long()], poses[graph.bt_j.long()], graph.bt_meas)
    wb = graph.bt_info * graph.bt_mask[:, None]
    chi2 = chi2 + torch.sum(wb * eb * eb)
    eg = vmap(lambda pi, m: gps_error(pi, z, m))(
        poses[graph.gps_i.long()], graph.gps_meas)
    wg = graph.gps_info * graph.gps_mask[:, None]
    return chi2 + torch.sum(wg * eg * eg)


def info_from_variances(variances, device=None) -> torch.Tensor:
    """gtsam noiseModel::Diagonal::Variances -> information diagonal."""
    v = torch.as_tensor(variances, dtype=torch.float32, device=device)
    return 1.0 / torch.clamp(v, min=1e-12)


def cauchy_weight(e_norm2: torch.Tensor, k: float = 0.5) -> torch.Tensor:
    """gtsam mEstimator::Cauchy(k) weight for the SC loop factors (:1250)."""
    return 1.0 / (1.0 + e_norm2 / (k * k))
