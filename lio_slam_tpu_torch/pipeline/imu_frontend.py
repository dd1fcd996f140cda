"""IMU front-end: preintegration-based state fusion + IMU-rate odometry
(port of `lio_slam_tpu/pipeline/imu_frontend.py`, imuPreintegration.cpp).

- `correct`: error-state update on [dtheta, dv, dp, dbg, dba] fusing the
  lidar pose (odometryHandler :271-516), with the symmetrization and the
  Joseph-form update of the JAX version, and the failure reset
  (failureDetection :496-516).  The window integrates with the log-depth
  `preintegrate_parallel`, as in the JAX front-end; the 15x15 covariance
  algebra runs in float64, the state stays float32.
- `predict_rate`: the pose at every IMU sample (imuHandler :518-613).
- `transform_fusion`: lidar odometry ∘ IMU increment (TransformFusion).

The JAX `lax.cond`s (initialized?, failure reset) are host branches here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lio_slam_tpu_torch.config import ImuConfig
from lio_slam_tpu_torch.ops import preintegration as pre
from lio_slam_tpu_torch.utils import se3


class ImuFrontendState(NamedTuple):
    nav: pre.NavState
    bias_gyr: torch.Tensor     # (3,)
    bias_acc: torch.Tensor     # (3,)
    cov: torch.Tensor          # (15, 15) error covariance [dth, dv, dp, dbg, dba]
    initialized: torch.Tensor  # () bool
    failure: torch.Tensor      # () bool — /mapping_error contract


def init_state(dtype=torch.float32, device=None) -> ImuFrontendState:
    z3 = torch.zeros(3, dtype=dtype, device=device)
    return ImuFrontendState(
        nav=pre.NavState(R=torch.eye(3, dtype=dtype, device=device), p=z3, v=z3),
        bias_gyr=z3, bias_acc=z3,
        cov=torch.eye(15, dtype=dtype, device=device) * 1e-2,
        initialized=torch.zeros((), dtype=torch.bool, device=device),
        failure=torch.zeros((), dtype=torch.bool, device=device))


def _init_cov(dtype, device) -> torch.Tensor:
    """Prior sigmas at initialization (imuPreintegration.cpp:222-231)."""
    d = torch.cat([torch.full((3,), 1e-2 ** 2), torch.full((3,), 1e4 ** 2),
                   torch.full((3,), 1e-2 ** 2), torch.full((6,), 1e-3 ** 2)])
    return torch.diag(d.to(dtype)).to(device)


def _anchored(lidar_pose6: torch.Tensor, bias_gyr, bias_acc,
              failure: bool) -> ImuFrontendState:
    Rm, pm = se3.pose6_to_Rt(lidar_pose6)
    dev = pm.device
    return ImuFrontendState(
        nav=pre.NavState(R=Rm, p=pm, v=torch.zeros_like(pm)),
        bias_gyr=bias_gyr, bias_acc=bias_acc,
        cov=_init_cov(pm.dtype, dev),
        initialized=torch.ones((), dtype=torch.bool, device=dev),
        failure=torch.full((), failure, dtype=torch.bool, device=dev))


def reinitialize(state: ImuFrontendState,
                 lidar_pose6: torch.Tensor) -> ImuFrontendState:
    """Re-anchor after a correction gap: pose from mapping, velocity zeroed,
    biases kept, fresh covariance (resetParams, :437-442)."""
    return _anchored(lidar_pose6, state.bias_gyr, state.bias_acc, False)


def make_frontend(cfg: ImuConfig):
    g = cfg.gravity
    # pileup threshold from the rig's nominal rate (half the period, capped
    # at the fork's 10 ms) — see preintegration.apply_pileup_gate
    min_dt = min(0.01, 0.5 / max(cfg.imu_rate, 1.0))

    def correct(state: ImuFrontendState, acc, gyr, dt, mask,
                lidar_pose6: torch.Tensor,
                degenerate: torch.Tensor) -> ImuFrontendState:
        """Fuse the lidar pose with the IMU window since the last correction."""
        Rm, pm = se3.pose6_to_Rt(lidar_pose6)
        dtype, dev = pm.dtype, pm.device
        if not bool(state.initialized):
            z3 = torch.zeros(3, dtype=dtype, device=dev)
            return _anchored(lidar_pose6, z3, z3, False)
        acc_g, gyr_g, dt_g = pre.apply_pileup_gate(acc, gyr, dt, g,
                                                   min_dt=min_dt)
        pint = pre.preintegrate_parallel(acc_g, gyr_g, dt_g, mask,
                                         state.bias_gyr, state.bias_acc,
                                         cfg.acc_noise, cfg.gyr_noise)
        nav = pre.predict(state.nav, pint, g)

        # The 15x15 covariance algebra runs in float64 (the JAX version pins
        # full float32 for the same reason).  The first update after
        # initialization meets the 1e8 velocity prior, and (I-KH) P cancels
        # about 8 digits there: in float32 the updated covariance (max 2.5)
        # comes out up to 0.4 off, and the next windows' gains inherit it.
        f64 = torch.float64
        w = pre.Preintegrated(*(x.to(f64) for x in pint))
        T = w.dt
        R0 = state.nav.R.to(f64)
        I3 = torch.eye(3, dtype=f64, device=dev)
        F = torch.eye(15, dtype=f64, device=dev)
        F[:3, :3] = w.dR.T
        F[3:6, :3] = -R0 @ se3.skew(w.dv)
        F[6:9, :3] = -R0 @ se3.skew(w.dp)
        F[6:9, 3:6] = I3 * T
        F[:3, 9:12] = w.dR_dbg
        F[3:6, 9:12] = R0 @ w.dv_dbg
        F[3:6, 12:15] = R0 @ w.dv_dba
        F[6:9, 9:12] = R0 @ w.dp_dbg
        F[6:9, 12:15] = R0 @ w.dp_dba
        Gblk = torch.block_diag(I3, R0, R0)
        Q = torch.zeros((15, 15), dtype=f64, device=dev)
        Q[:9, :9] = Gblk @ w.cov @ Gblk.T
        Q[9:12, 9:12] = I3 * cfg.gyr_bias_noise ** 2 * T
        Q[12:15, 12:15] = I3 * cfg.acc_bias_noise ** 2 * T
        P = F @ state.cov.to(f64) @ F.T + Q

        # correctionNoise 0.05 rad / 0.1 m, inflated when degenerate
        sr = torch.where(degenerate, 1.0, 0.05).to(f64)
        st = torch.where(degenerate, 1.0, 0.1).to(f64)
        Rn = torch.diag(torch.cat([(sr ** 2).expand(3), (st ** 2).expand(3)]))
        H = torch.zeros((6, 15), dtype=f64, device=dev)
        H[:3, :3] = I3
        H[3:6, 6:9] = I3
        r = torch.cat([se3.so3_log(nav.R.T @ Rm), pm - nav.p]).to(f64)

        # symmetrize, solve (no explicit inverse), Joseph-form update
        P = 0.5 * (P + P.T)
        S = H @ P @ H.T + Rn
        S = 0.5 * (S + S.T)
        K = torch.linalg.solve_ex(S, H @ P)[0].T
        dx = (K @ r).to(dtype)
        IKH = torch.eye(15, dtype=f64, device=dev) - K @ H
        P_new = (IKH @ P @ IKH.T + K @ Rn @ K.T).to(dtype)

        nav_new = pre.NavState(R=nav.R @ se3.so3_exp(dx[:3]),
                               p=nav.p + dx[6:9], v=nav.v + dx[3:6])
        bg = state.bias_gyr + dx[9:12]
        ba = state.bias_acc + dx[12:15]
        if bool(pre.failure_detected(nav_new, bg, ba)):
            z3 = torch.zeros(3, dtype=dtype, device=dev)
            return _anchored(lidar_pose6, z3, z3, True)
        return ImuFrontendState(
            nav=nav_new, bias_gyr=bg, bias_acc=ba, cov=0.5 * (P_new + P_new.T),
            initialized=torch.ones((), dtype=torch.bool, device=dev),
            failure=torch.zeros((), dtype=torch.bool, device=dev))

    def predict_rate(state: ImuFrontendState, acc, gyr, dt, mask):
        """Pose at every sample of the window, from the last fused state
        (the odometry/imu_incremental stream as one (T, 6) tensor)."""
        acc_g, gyr_g, dt_g = pre.apply_pileup_gate(acc, gyr, dt, g,
                                                   min_dt=min_dt)
        return pre.integrate_pose_train(
            state.nav.R, state.nav.p, state.nav.v,
            acc_g - state.bias_acc, gyr_g - state.bias_gyr, dt_g, mask, g)

    def transform_fusion(lidar_odom6, imu_front6, imu_back6):
        """Final high-rate pose = lidarOdom ∘ (imuFront^{-1} ∘ imuBack)
        (TransformFusion::imuOdometryHandler :107-129); batched over the
        leading dims of `imu_back6`."""
        inc = se3.pose6_between(imu_front6.expand_as(imu_back6), imu_back6)
        return se3.pose6_compose(lidar_odom6.expand_as(inc), inc)

    return correct, predict_rate, transform_fusion
