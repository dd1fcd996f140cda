"""The port's log-depth `preintegrate_parallel` and `associative_scan`
against the port's sequential `preintegrate` (the seven cases of
tests/test_preintegration_parallel.py, at its tolerances) and against the
JAX package's parallel form and front-end.

The port's parallel form agrees with the JAX parallel form within 1e-5 of
each field's largest entry on the windows below; measured on the CPU: at
most 3.8e-6 (the bias Jacobians of a 64-sample window), 1.2e-6 for the
covariance, each form about 1e-6 from a float64 run of the sequential
form.  The front-end, which integrates with the parallel form, follows the
JAX front-end over five windows from a well-conditioned state within
1e-5 (state) and 1e-4 relative (covariance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H  # noqa: F401  (single-threaded torch)
from torch_port_helpers import n, t
from lio_slam_tpu.config import ImuConfig as JImu
from lio_slam_tpu.ops import preintegration as jpre
from lio_slam_tpu.pipeline import imu_frontend as jfe
from lio_slam_tpu_torch.config import ImuConfig as TImu
from lio_slam_tpu_torch.ops import preintegration as pre
from lio_slam_tpu_torch.pipeline import imu_frontend as fe
from lio_slam_tpu_torch.utils import smallmat

G = 9.80511


def random_window(n=200, seed=0, masked_tail=0):
    rs = np.random.RandomState(seed)
    acc = rs.randn(n, 3).astype(np.float32) * 0.5 + np.float32([0, 0, G])
    gyr = rs.randn(n, 3).astype(np.float32) * 0.3
    dt = rs.uniform(0.004, 0.006, n).astype(np.float32)
    mask = np.arange(n) < (n - masked_tail)
    return acc, gyr, dt, mask


def both(acc, gyr, dt, mask, bg=None, ba=None):
    bg = torch.zeros(3) if bg is None else t(bg, torch.float32)
    ba = torch.zeros(3) if ba is None else t(ba, torch.float32)
    args = (t(acc), t(gyr), t(dt), t(mask), bg, ba, 1e-2, 1e-3)
    return pre.preintegrate(*args), pre.preintegrate_parallel(*args)


class TestParallelMatchesSequential:
    def test_deltas(self):
        seq, par = both(*random_window())
        np.testing.assert_allclose(n(par.dR), n(seq.dR), atol=2e-5)
        np.testing.assert_allclose(n(par.dv), n(seq.dv), atol=2e-4)
        np.testing.assert_allclose(n(par.dp), n(seq.dp), atol=2e-4)
        np.testing.assert_allclose(n(par.dt), n(seq.dt), atol=1e-6)

    def test_bias_jacobians(self):
        seq, par = both(*random_window(seed=1))
        for name in ("dR_dbg", "dv_dbg", "dv_dba", "dp_dbg", "dp_dba"):
            np.testing.assert_allclose(n(getattr(par, name)),
                                       n(getattr(seq, name)), atol=5e-3,
                                       err_msg=name)

    def test_covariance(self):
        seq, par = both(*random_window(seed=2))
        sc, pc_ = n(seq.cov), n(par.cov)
        np.testing.assert_allclose(pc_, pc_.T, atol=1e-8)
        scale = np.abs(sc).max()
        np.testing.assert_allclose(pc_, sc, atol=scale * 2e-2 + 1e-10)

    def test_masked_tail(self):
        seq, par = both(*random_window(seed=3, masked_tail=60))
        np.testing.assert_allclose(n(par.dR), n(seq.dR), atol=2e-5)
        np.testing.assert_allclose(n(par.dv), n(seq.dv), atol=2e-4)
        np.testing.assert_allclose(n(par.cov), n(seq.cov),
                                   atol=np.abs(n(seq.cov)).max() * 2e-2)

    def test_with_bias(self):
        seq, par = both(*random_window(seed=4),
                        bg=[0.01, -0.02, 0.005], ba=[0.1, 0.05, -0.08])
        np.testing.assert_allclose(n(par.dv), n(seq.dv), atol=2e-4)
        np.testing.assert_allclose(n(par.dp), n(seq.dp), atol=2e-4)


class TestPoseTrain:
    def test_matches_sequential_frontend(self):
        """The pose train reproduces a per-sample integration of the same
        window (here the port's sequential composition of the rates)."""
        correct, predict_rate, _ = fe.make_frontend(TImu(gravity=G))
        st = fe.init_state()
        acc = torch.tensor([[0.1, 0.0, G]]).repeat(40, 1)
        gyr = torch.tensor([[0.0, 0.0, 0.4]]).repeat(40, 1)
        dt = torch.full((40,), 0.02)
        mask = torch.ones(40, dtype=torch.bool)
        st = correct(st, acc, gyr, dt, mask, torch.zeros(6), torch.tensor(False))
        par_poses = predict_rate(st, acc, gyr, dt, mask)
        # sequential: R_k = R_{k-1} exp(w dt), v and p by the same steps
        R, p, v = st.nav.R, st.nav.p, st.nav.v
        g = torch.tensor([0.0, 0.0, -G])
        seq_poses = []
        for k in range(40):
            a_w = R @ (acc[k] - st.bias_acc) + g
            p = p + v * dt[k] + 0.5 * a_w * dt[k] ** 2
            v = v + a_w * dt[k]
            R = R @ pre.se3.so3_exp((gyr[k] - st.bias_gyr) * dt[k])
            seq_poses.append(pre.se3.Rt_to_pose6(R, p))
        np.testing.assert_allclose(n(par_poses), n(torch.stack(seq_poses)),
                                   atol=2e-4)

    def test_pure_rotation(self):
        poses = pre.integrate_pose_train(
            torch.eye(3), torch.zeros(3), torch.zeros(3),
            torch.tensor([[0.0, 0.0, G]]).repeat(100, 1),
            torch.tensor([[0.0, 0.0, 0.5]]).repeat(100, 1),
            torch.full((100,), 0.01), torch.ones(100, dtype=torch.bool), G)
        np.testing.assert_allclose(float(poses[-1, 2]), 0.5, atol=5e-3)
        np.testing.assert_allclose(n(poses[-1, 3:]), 0.0, atol=5e-3)


@pytest.mark.parametrize("T", [1, 2, 5, 8, 13, 64])
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_pairs_as_jax(T, reverse):
    """On integers the scan's sums are exact; on 3x3 float32 products its
    pairing is JAX's, so the results agree to the rounding of a matmul."""
    x = np.arange(1, T + 1, dtype=np.int64)
    np.testing.assert_array_equal(
        n(smallmat.associative_scan(torch.add, t(x), reverse=reverse)),
        np.asarray(jax.lax.associative_scan(jnp.add, jnp.asarray(x),
                                            reverse=reverse)))
    rs = np.random.RandomState(T)
    m = np.asarray(jax.vmap(jpre.se3.so3_exp)(jnp.asarray(
        rs.randn(T, 3).astype(np.float32) * 0.3)))
    a = jax.lax.associative_scan(lambda u, w: jnp.einsum("...ij,...jk->...ik",
                                                         u, w),
                                 jnp.asarray(m), reverse=reverse)
    b = smallmat.associative_scan(torch.matmul, t(m), reverse=reverse)
    np.testing.assert_allclose(n(b), np.asarray(a), atol=2e-6)


WINDOWS = {
    "200 samples": dict(n=200, seed=5),
    "64 samples, 10 valid": dict(n=64, seed=6, masked_tail=54),
    "masked tail": dict(n=200, seed=7, masked_tail=60),
    "biases": dict(n=64, seed=8),
}


@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_parallel_matches_jax_parallel(case):
    acc, gyr, dt, mask = random_window(**WINDOWS[case])
    bg = np.zeros(3, np.float32)
    ba = np.zeros(3, np.float32)
    if case == "biases":
        bg = np.array([0.01, -0.02, 0.005], np.float32)
        ba = np.array([0.1, 0.05, -0.08], np.float32)
    a = jpre.preintegrate_parallel(*map(jnp.asarray, (acc, gyr, dt, mask, bg,
                                                       ba)), 1e-2, 1e-3)
    b = pre.preintegrate_parallel(t(acc), t(gyr), t(dt), t(mask), t(bg),
                                  t(ba), 1e-2, 1e-3)
    for name in b._fields:
        ref = np.asarray(getattr(a, name))
        scale = np.abs(ref).max()
        np.testing.assert_allclose(n(getattr(b, name)), ref,
                                   atol=1e-5 * scale + 1e-12, err_msg=name)


def test_frontend_correct_matches_jax_over_five_windows():
    """Both front-ends integrate with the parallel form; from a
    well-conditioned state five corrections stay together."""
    jc, _, _ = jfe.make_frontend(JImu(gravity=G, imu_rate=100.0))
    tc, _, _ = fe.make_frontend(TImu(gravity=G, imu_rate=100.0))
    v0 = np.array([2.0, 0.0, 0.0], np.float32)
    sa = jfe.init_state()._replace(initialized=jnp.asarray(True),
                                   nav=jpre.NavState(R=jnp.eye(3),
                                                     p=jnp.zeros(3),
                                                     v=jnp.asarray(v0)))
    sb = fe.init_state()._replace(initialized=torch.tensor(True),
                                  nav=pre.NavState(R=torch.eye(3),
                                                   p=torch.zeros(3), v=t(v0)))
    for k in range(1, 6):
        rs = np.random.RandomState(20 + k)
        T, valid = 64, 10
        acc = (np.array([0.3, -0.1, G]) + rs.randn(T, 3) * 0.05).astype(np.float32)
        gyr = (np.array([0.01, -0.02, 0.2]) + rs.randn(T, 3) * 0.01).astype(np.float32)
        dts = np.full(T, 0.01, np.float32)
        mask = np.arange(T) < valid
        pose = np.array([0.01, 0.02, 0.02 * k, 0.2 * k, 0.01 * k * k, 0.5],
                        np.float32)
        sa = jc(sa, acc, gyr, dts, mask, jnp.asarray(pose), jnp.asarray(k == 3))
        sb = tc(sb, t(acc), t(gyr), t(dts), t(mask), t(pose),
                torch.tensor(k == 3))
        for x, y in zip((sa.nav.R, sa.nav.p, sa.nav.v, sa.bias_gyr,
                         sa.bias_acc),
                        (sb.nav.R, sb.nav.p, sb.nav.v, sb.bias_gyr,
                         sb.bias_acc)):
            np.testing.assert_allclose(n(y), np.asarray(x), atol=1e-5)
        np.testing.assert_allclose(n(sb.cov), np.asarray(sa.cov), rtol=1e-4,
                                   atol=1e-9)
        assert bool(sb.failure) == bool(sa.failure)
