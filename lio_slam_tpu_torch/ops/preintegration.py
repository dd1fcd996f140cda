"""IMU preintegration (port of `lio_slam_tpu/ops/preintegration.py`,
imuPreintegration.cpp:167-614; Forster et al., RSS 2015).

`preintegrate_parallel` is the form the front-end integrates with, as in
the JAX package: cumulative rotations and the 9x9 suffix transition
products by the log-depth `smallmat.associative_scan` (the combine order
of `jax.lax.associative_scan`), dv and dp by cumsums, the covariance and the
bias Jacobians as batched sums.  `preintegrate` is the sequential form, a
host loop over the window kept as the readable reference.
`integrate_pose_train` builds its cumulative rotations with the same scan.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lio_slam_tpu_torch.utils import se3, smallmat


class Preintegrated(NamedTuple):
    dR: torch.Tensor        # (3, 3) rotation delta (body_i <- body_j)
    dv: torch.Tensor        # (3,)
    dp: torch.Tensor        # (3,)
    dt: torch.Tensor        # ()
    dR_dbg: torch.Tensor    # (3, 3) bias-correction Jacobians
    dv_dbg: torch.Tensor
    dv_dba: torch.Tensor
    dp_dbg: torch.Tensor
    dp_dba: torch.Tensor
    cov: torch.Tensor       # (9, 9) covariance of [dtheta, dv, dp]
    bias_gyr: torch.Tensor  # (3,)
    bias_acc: torch.Tensor  # (3,)


class NavState(NamedTuple):
    R: torch.Tensor         # (3, 3) body->world
    p: torch.Tensor         # (3,)
    v: torch.Tensor         # (3,)


def apply_pileup_gate(acc: torch.Tensor, gyr: torch.Tensor, dt: torch.Tensor,
                      gravity: float, min_dt: float = 0.01,
                      fallback_dt: float = 1.0 / 50.0):
    """Anti-pileup gating (imuPreintegration.cpp:376-401): samples closer
    than `min_dt` integrate as the stationary placeholder (acc = (0,0,g),
    omega = 0); non-positive dt becomes `fallback_dt`."""
    piled = dt < min_dt * 0.999
    placeholder = torch.tensor([0.0, 0.0, gravity], dtype=acc.dtype,
                               device=acc.device)
    acc = torch.where(piled[:, None], placeholder, acc)
    gyr = torch.where(piled[:, None], torch.zeros_like(gyr), gyr)
    dt = torch.where(dt <= 0.0, torch.full_like(dt, fallback_dt), dt)
    return acc, gyr, dt


def preintegrate(acc: torch.Tensor, gyr: torch.Tensor, dt: torch.Tensor,
                 mask: torch.Tensor, bias_gyr: torch.Tensor,
                 bias_acc: torch.Tensor, acc_noise: float, gyr_noise: float,
                 init_cov: float = 1e-8) -> Preintegrated:
    """Integrate an IMU window (N samples) into a `Preintegrated` delta;
    masked samples are no-ops."""
    dtype, dev = acc.dtype, acc.device
    dtf = torch.where(mask, dt, torch.zeros_like(dt)).to(dtype)
    a = acc - bias_acc
    w = gyr - bias_gyr
    sig_g2 = torch.tensor(gyr_noise, dtype=dtype, device=dev) ** 2
    sig_a2 = torch.tensor(acc_noise, dtype=dtype, device=dev) ** 2
    theta = w * dtf[:, None]
    dRk_all = se3.so3_exp(theta)
    Jr_all = se3.so3_right_jacobian(theta)
    A_skew_all = se3.skew(a)
    Z = torch.zeros((3, 3), dtype=dtype, device=dev)
    I3 = torch.eye(3, dtype=dtype, device=dev)

    eye = torch.eye(3, dtype=dtype, device=dev)
    st = Preintegrated(dR=eye, dv=torch.zeros(3, dtype=dtype, device=dev),
                       dp=torch.zeros(3, dtype=dtype, device=dev),
                       dt=torch.zeros((), dtype=dtype, device=dev),
                       dR_dbg=Z, dv_dbg=Z, dv_dba=Z, dp_dbg=Z, dp_dba=Z,
                       cov=torch.eye(9, dtype=dtype, device=dev) * init_cov,
                       bias_gyr=bias_gyr.to(dtype), bias_acc=bias_acc.to(dtype))
    for k in range(acc.shape[0]):
        a_k, dt_k = a[k], dtf[k]
        dRk, Jr = dRk_all[k], Jr_all[k]
        Ra = st.dR @ a_k
        dt2 = dt_k * dt_k
        dp = st.dp + st.dv * dt_k + 0.5 * Ra * dt2
        dv = st.dv + Ra * dt_k
        dR = st.dR @ dRk
        A_hat = st.dR @ A_skew_all[k]
        dp_dbg = st.dp_dbg + st.dv_dbg * dt_k - 0.5 * A_hat @ st.dR_dbg * dt2
        dp_dba = st.dp_dba + st.dv_dba * dt_k - 0.5 * st.dR * dt2
        dv_dbg = st.dv_dbg - A_hat @ st.dR_dbg * dt_k
        dv_dba = st.dv_dba - st.dR * dt_k
        dR_dbg = dRk.T @ st.dR_dbg - Jr * dt_k
        A = torch.cat([
            torch.cat([dRk.T, Z, Z], dim=1),
            torch.cat([-A_hat * dt_k, I3, Z], dim=1),
            torch.cat([-0.5 * A_hat * dt2, I3 * dt_k, I3], dim=1)], dim=0)
        Bg = torch.cat([Jr * dt_k, Z, Z], dim=0)
        Ba = torch.cat([Z, st.dR * dt_k, 0.5 * st.dR * dt2], dim=0)
        inv_dt = torch.where(dt_k > 0, 1.0 / torch.clamp(dt_k, min=1e-6),
                             torch.zeros_like(dt_k))
        cov = (A @ st.cov @ A.T
               + Bg @ (sig_g2 * inv_dt * I3) @ Bg.T
               + Ba @ (sig_a2 * inv_dt * I3) @ Ba.T)
        new = st._replace(dR=dR, dv=dv, dp=dp, dt=st.dt + dt_k,
                          dR_dbg=dR_dbg, dv_dbg=dv_dbg, dv_dba=dv_dba,
                          dp_dbg=dp_dbg, dp_dba=dp_dba, cov=cov)
        skip = dt_k <= 0.0           # masked sample: keep the state exactly
        st = Preintegrated(*(torch.where(skip, o, n) for n, o in zip(new, st)))
    return st


def preintegrate_parallel(acc: torch.Tensor, gyr: torch.Tensor,
                          dt: torch.Tensor, mask: torch.Tensor,
                          bias_gyr: torch.Tensor, bias_acc: torch.Tensor,
                          acc_noise: float, gyr_noise: float,
                          init_cov: float = 1e-8) -> Preintegrated:
    """`preintegrate` in log depth (JAX `preintegrate_parallel`), the same
    math up to float reassociation:

    - cumulative rotations D_i = prod exp(w_j dt_j) by an associative
      matmul scan;
    - dv and dp by cumsums of the rotated increments;
    - per-sample 9x9 transitions A_j and noise Q_j, the suffix products
      S_j = A_T ... A_{j+1} by a reverse associative scan;
    - covariance P = S_0 P_0 S_0^T + sum_j S_j Q_j S_j^T and bias Jacobians
      J = sum_j S_j C_j."""
    dtype, dev = acc.dtype, acc.device
    T = acc.shape[0]
    dtf = torch.where(mask, dt, torch.zeros_like(dt)).to(dtype)
    a = acc - bias_acc
    w = gyr - bias_gyr
    sig_g2 = torch.tensor(gyr_noise, dtype=dtype, device=dev) ** 2
    sig_a2 = torch.tensor(acc_noise, dtype=dtype, device=dev) ** 2

    theta = w * dtf[:, None]
    dRk = se3.so3_exp(theta)                                # (T, 3, 3)
    Jr = se3.so3_right_jacobian(theta)

    D = smallmat.associative_scan(torch.matmul, dRk)
    eye = torch.eye(3, dtype=dtype, device=dev)[None]
    D_prev = torch.cat([eye, D[:-1]], dim=0)

    Ra = torch.einsum("tij,tj->ti", D_prev, a)
    dt2 = dtf * dtf
    dv_cum = torch.cumsum(Ra * dtf[:, None], dim=0)
    dv_prev = torch.cat([torch.zeros((1, 3), dtype=dtype, device=dev),
                         dv_cum[:-1]], dim=0)
    dp = torch.sum(dv_prev * dtf[:, None] + 0.5 * Ra * dt2[:, None], dim=0)

    dt_ = dtf[:, None, None]
    dt2_ = dt2[:, None, None]
    Ahat = torch.einsum("tij,tjk->tik", D_prev, se3.skew(a))  # D_{j-1} [a]x
    Z = torch.zeros((T, 3, 3), dtype=dtype, device=dev)
    I3 = eye.expand(T, 3, 3)
    A = torch.cat([
        torch.cat([dRk.transpose(-1, -2), Z, Z], dim=-1),
        torch.cat([-Ahat * dt_, I3, Z], dim=-1),
        torch.cat([-0.5 * Ahat * dt2_, I3 * dt_, I3], dim=-1)], dim=-2)
    Bg = torch.cat([Jr * dt_, Z, Z], dim=-2)                # (T, 9, 3)
    Ba = torch.cat([Z, D_prev * dt_, 0.5 * D_prev * dt2_], dim=-2)
    inv_dt = torch.where(dtf > 0, 1.0 / torch.clamp(dtf, min=1e-6),
                         torch.zeros_like(dtf))
    Q = (torch.einsum("tik,tjk->tij", Bg, Bg) * (sig_g2 * inv_dt)[:, None, None]
         + torch.einsum("tik,tjk->tij", Ba, Ba) * (sig_a2 * inv_dt)[:, None, None])

    # S[j] = A_T ... A_j; the exclusive suffix S_excl[j] = A_T ... A_{j+1}
    S = smallmat.associative_scan(torch.matmul, A, reverse=True)
    S_excl = torch.cat([S[1:], torch.eye(9, dtype=dtype, device=dev)[None]],
                       dim=0)
    P0 = torch.eye(9, dtype=dtype, device=dev) * init_cov
    S0 = S[0]
    cov = S0 @ P0 @ S0.T + torch.einsum("tij,tjk,tlk->il", S_excl, Q, S_excl)

    Cg = torch.cat([-Jr * dt_, Z, Z], dim=-2)
    Ca = torch.cat([Z, -D_prev * dt_, -0.5 * D_prev * dt2_], dim=-2)
    Jg = torch.einsum("tij,tjk->ik", S_excl, Cg)            # (9, 3)
    Ja = torch.einsum("tij,tjk->ik", S_excl, Ca)
    return Preintegrated(
        dR=D[-1], dv=dv_cum[-1], dp=dp, dt=torch.sum(dtf),
        dR_dbg=Jg[:3], dv_dbg=Jg[3:6], dv_dba=Ja[3:6],
        dp_dbg=Jg[6:9], dp_dba=Ja[6:9], cov=cov,
        bias_gyr=bias_gyr.to(dtype), bias_acc=bias_acc.to(dtype))


def integrate_pose_train(R0: torch.Tensor, p0: torch.Tensor, v0: torch.Tensor,
                         acc: torch.Tensor, gyr: torch.Tensor, dt: torch.Tensor,
                         mask: torch.Tensor, gravity: float) -> torch.Tensor:
    """Pose6 at every IMU sample of the window (odometry/imu_incremental)."""
    dtype, dev = acc.dtype, acc.device
    dtf = torch.where(mask, dt, torch.zeros_like(dt)).to(dtype)
    dRk = se3.so3_exp(gyr * dtf[:, None])
    D = smallmat.associative_scan(torch.matmul, dRk)
    eye = torch.eye(3, dtype=dtype, device=dev)[None]
    D_prev = torch.cat([eye, D[:-1]], dim=0)
    R = torch.einsum("ij,tjk->tik", R0, D)
    R_prev = torch.einsum("ij,tjk->tik", R0, D_prev)
    g = torch.tensor([0.0, 0.0, -gravity], dtype=dtype, device=dev)
    acc_w = torch.einsum("tij,tj->ti", R_prev, acc) + g[None, :]
    v = v0[None, :] + torch.cumsum(acc_w * dtf[:, None], dim=0)
    v_prev = torch.cat([v0[None, :], v[:-1]], dim=0)
    p_steps = v_prev * dtf[:, None] + 0.5 * acc_w * dtf[:, None] * dtf[:, None]
    p = p0[None, :] + torch.cumsum(p_steps, dim=0)
    return se3.Rt_to_pose6(R, p)


def bias_corrected(pre: Preintegrated, bias_gyr: torch.Tensor,
                   bias_acc: torch.Tensor) -> Preintegrated:
    """First-order update of the deltas to a new bias estimate."""
    dbg = bias_gyr - pre.bias_gyr
    dba = bias_acc - pre.bias_acc
    return pre._replace(dR=pre.dR @ se3.so3_exp(pre.dR_dbg @ dbg),
                        dv=pre.dv + pre.dv_dbg @ dbg + pre.dv_dba @ dba,
                        dp=pre.dp + pre.dp_dbg @ dbg + pre.dp_dba @ dba,
                        bias_gyr=bias_gyr, bias_acc=bias_acc)


def predict(state: NavState, pre: Preintegrated, gravity: float) -> NavState:
    """NavState propagation (gtsam NavState::predict); world gravity is
    (0, 0, -gravity)."""
    g = torch.tensor([0.0, 0.0, -gravity], dtype=pre.dv.dtype,
                     device=pre.dv.device)
    t = pre.dt
    return NavState(R=state.R @ pre.dR,
                    p=state.p + state.v * t + 0.5 * g * t * t + state.R @ pre.dp,
                    v=state.v + g * t + state.R @ pre.dv)


def failure_detected(state: NavState, bias_gyr: torch.Tensor,
                     bias_acc: torch.Tensor, vel_limit: float = 30.0,
                     bias_limit: float = 1.0) -> torch.Tensor:
    """Divergence check (imuPreintegration.cpp:496-516)."""
    return ((torch.linalg.norm(state.v) > vel_limit)
            | (torch.linalg.norm(bias_acc) > bias_limit)
            | (torch.linalg.norm(bias_gyr) > bias_limit))
