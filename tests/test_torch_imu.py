"""ops/preintegration and pipeline/imu_frontend of the port against the JAX
package.

The port integrates IMU windows with the sequential `preintegrate`; the JAX
front-end uses `preintegrate_parallel` (the same sums reassociated).  On a
64-sample window the two agree within 1e-5 (deltas) and 1e-6 absolute
(covariance), stated below.

The front-end's first update after (re)initialization starts from a 1e8
velocity variance.  In float32 its Joseph-form covariance cancels about 8
digits: on the window below the JAX front-end's comes out 8.0 off the
float64 value (largest entry 1.19).  The port runs that 15x15 algebra in
float64, so after the first update its fused state is compared with JAX's
and its covariance with the port's own all-float64 run.  Later windows are
compared with JAX from a well-conditioned covariance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t
from lio_slam_tpu.config import ImuConfig as JImu
from lio_slam_tpu.ops import preintegration as jpre
from lio_slam_tpu.pipeline import imu_frontend as jfe
from lio_slam_tpu_torch.config import ImuConfig as TImu
from lio_slam_tpu_torch.ops import preintegration as tpre
from lio_slam_tpu_torch.pipeline import imu_frontend as tfe

G = 9.80511


def window(seed=0, T=64, n_valid=50, dt=0.01):
    rs = np.random.RandomState(seed)
    acc = (np.array([0.3, -0.1, G]) + rs.randn(T, 3) * 0.05).astype(np.float32)
    gyr = (np.array([0.01, -0.02, 0.2]) + rs.randn(T, 3) * 0.01).astype(np.float32)
    dts = np.full(T, dt, np.float32)
    dts[5] = 0.002                                      # a piled-up sample
    mask = np.arange(T) < n_valid
    return acc, gyr, dts, mask


def test_pileup_gate():
    acc, gyr, dts, _ = window()
    dts[7] = 0.0
    a = jpre.apply_pileup_gate(jnp.asarray(acc), jnp.asarray(gyr), jnp.asarray(dts),
                               G, min_dt=0.005)
    b = tpre.apply_pileup_gate(t(acc), t(gyr), t(dts), G, min_dt=0.005)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(n(y), n(x))


@pytest.mark.parametrize("jax_fn,atol", [("preintegrate", 1e-5),
                                         ("preintegrate_parallel", 1e-5)])
def test_preintegrate(jax_fn, atol):
    acc, gyr, dts, mask = window(1)
    bg = np.array([0.001, -0.002, 0.003], np.float32)
    ba = np.array([0.01, 0.02, -0.01], np.float32)
    a = getattr(jpre, jax_fn)(jnp.asarray(acc), jnp.asarray(gyr), jnp.asarray(dts),
                              jnp.asarray(mask), jnp.asarray(bg), jnp.asarray(ba),
                              4e-3, 1.5e-3)
    b = tpre.preintegrate(t(acc), t(gyr), t(dts), t(mask), t(bg), t(ba),
                          4e-3, 1.5e-3)
    for name in b._fields:
        tol = 1e-6 if name == "cov" else atol
        np.testing.assert_allclose(n(getattr(b, name)), n(getattr(a, name)),
                                   rtol=1e-5, atol=tol, err_msg=name)


def test_pose_train_bias_predict_failure():
    acc, gyr, dts, mask = window(2)
    R0 = np.asarray(jpre.se3.rpy_to_matrix(jnp.asarray([0.02, -0.01, 0.5])))
    p0 = np.array([1.0, 2.0, 0.5], np.float32)
    v0 = np.array([2.0, 0.1, 0.0], np.float32)
    a = jpre.integrate_pose_train(jnp.asarray(R0), jnp.asarray(p0), jnp.asarray(v0),
                                  jnp.asarray(acc), jnp.asarray(gyr),
                                  jnp.asarray(dts), jnp.asarray(mask), G)
    b = tpre.integrate_pose_train(t(R0), t(p0), t(v0), t(acc), t(gyr), t(dts),
                                  t(mask), G)
    np.testing.assert_allclose(n(b), n(a), atol=2e-5)

    pa = jpre.preintegrate(jnp.asarray(acc), jnp.asarray(gyr), jnp.asarray(dts),
                           jnp.asarray(mask), jnp.zeros(3), jnp.zeros(3), 4e-3, 1.5e-3)
    pb = tpre.preintegrate(t(acc), t(gyr), t(dts), t(mask), torch.zeros(3),
                           torch.zeros(3), 4e-3, 1.5e-3)
    bg = np.array([0.002, 0.0, -0.001], np.float32)
    ba = np.array([0.0, 0.03, 0.0], np.float32)
    ca = jpre.bias_corrected(pa, jnp.asarray(bg), jnp.asarray(ba))
    cb = tpre.bias_corrected(pb, t(bg), t(ba))
    for name in ("dR", "dv", "dp"):
        np.testing.assert_allclose(n(getattr(cb, name)), n(getattr(ca, name)),
                                   atol=1e-5)
    na = jpre.predict(jpre.NavState(R=jnp.asarray(R0), p=jnp.asarray(p0),
                                    v=jnp.asarray(v0)), ca, G)
    nb = tpre.predict(tpre.NavState(R=t(R0), p=t(p0), v=t(v0)), cb, G)
    for x, y in zip(na, nb):
        np.testing.assert_allclose(n(y), n(x), atol=2e-5)
    for v, bias in ((v0, bg), (v0 * 20, bg), (v0, bg * 1000)):
        assert bool(tpre.failure_detected(nb._replace(v=t(v)), t(bias), t(ba))) == \
            bool(jpre.failure_detected(na._replace(v=jnp.asarray(v)),
                                       jnp.asarray(bias), jnp.asarray(ba)))


def frontends():
    jc, jp, jt = jfe.make_frontend(JImu(gravity=G, imu_rate=100.0))
    tc, tp, tt = tfe.make_frontend(TImu(gravity=G, imu_rate=100.0))
    return (jc, jp, jt), (tc, tp, tt)


def front_window(k, T=32, n_valid=10):
    acc, gyr, dts, mask = window(10 + k, T=T, n_valid=n_valid)
    pose = np.array([0.01, 0.02, 0.02 * k, 0.2 * k, 0.01 * k * k, 0.5], np.float32)
    return acc, gyr, dts, mask, pose


def assert_state_close(b, a, atol):
    for x, y in zip((a.nav.R, a.nav.p, a.nav.v, a.bias_gyr, a.bias_acc),
                    (b.nav.R, b.nav.p, b.nav.v, b.bias_gyr, b.bias_acc)):
        np.testing.assert_allclose(n(y), n(x), atol=atol)
    assert bool(b.initialized) == bool(a.initialized)
    assert bool(b.failure) == bool(a.failure)


def test_frontend_initialize_and_first_update():
    (jc, jp, jt), (tc, tp, tt) = frontends()
    sa, sb = jfe.init_state(), tfe.init_state()
    for k in range(2):
        acc, gyr, dts, mask, pose = front_window(k)
        sa = jc(sa, acc, gyr, dts, mask, jnp.asarray(pose), jnp.asarray(False))
        sb = tc(sb, t(acc), t(gyr), t(dts), t(mask), t(pose), torch.tensor(False))
        assert_state_close(sb, sa, atol=1e-5)
    np.testing.assert_allclose(n(sb.cov)[:3, :3], n(sa.cov)[:3, :3], atol=1e-6)
    acc, gyr, dts, mask, _ = front_window(2)
    ra = jp(sa, acc, gyr, dts, mask)
    rb = tp(sb, t(acc), t(gyr), t(dts), t(mask))
    np.testing.assert_allclose(n(rb), n(ra), atol=1e-4)
    lidar = np.array([0.0, 0.01, 0.3, 1.0, 2.0, 0.4], np.float32)
    fa = jax.vmap(jt, in_axes=(None, None, 0))(jnp.asarray(lidar), ra[0], ra)
    fb = tt(t(lidar), rb[0], rb)
    np.testing.assert_allclose(n(fb), n(fa), atol=1e-4)


def test_first_update_covariance_is_float64_exact():
    """The covariance after the first update, against the same front-end
    run on float64 inputs: measured 1.7e-7 apart."""
    (jc, _, _), (tc, _, _) = frontends()
    sa, sb = jfe.init_state(), tfe.init_state()
    s64 = tfe.init_state(dtype=torch.float64)
    f64 = lambda x: t(x, torch.float64)
    for k in range(2):
        acc, gyr, dts, mask, pose = front_window(k)
        sa = jc(sa, acc, gyr, dts, mask, jnp.asarray(pose), jnp.asarray(False))
        sb = tc(sb, t(acc), t(gyr), t(dts), t(mask), t(pose), torch.tensor(False))
        s64 = tc(s64, f64(acc), f64(gyr), f64(dts), t(mask), f64(pose),
                 torch.tensor(False))
    assert sb.cov.dtype == torch.float32
    np.testing.assert_allclose(n(sb.cov), n(s64.cov), rtol=1e-6, atol=1e-5)
    assert_state_close(sb, sa, atol=1e-5)
    np.testing.assert_allclose(n(sb.nav.v), n(s64.nav.v), atol=1e-5)


@pytest.mark.parametrize("degenerate", [False, True])
def test_frontend_updates_from_conditioned_state(degenerate):
    (jc, _, _), (tc, _, _) = frontends()
    R0 = np.eye(3, dtype=np.float32)
    sa = jfe.init_state()._replace(initialized=jnp.asarray(True),
                                   nav=jpre.NavState(R=jnp.asarray(R0),
                                                     p=jnp.zeros(3),
                                                     v=jnp.asarray([2.0, 0.0, 0.0])))
    sb = tfe.init_state()._replace(initialized=torch.tensor(True),
                                   nav=tpre.NavState(R=t(R0), p=torch.zeros(3),
                                                     v=torch.tensor([2.0, 0.0, 0.0])))
    for k in range(1, 5):
        acc, gyr, dts, mask, pose = front_window(k)
        sa = jc(sa, acc, gyr, dts, mask, jnp.asarray(pose), jnp.asarray(degenerate))
        sb = tc(sb, t(acc), t(gyr), t(dts), t(mask), t(pose),
                torch.tensor(degenerate))
        assert_state_close(sb, sa, atol=1e-4)
        np.testing.assert_allclose(n(sb.cov), n(sa.cov), rtol=1e-3, atol=1e-6)


def test_reinitialize():
    sa = jfe.init_state()._replace(bias_gyr=jnp.asarray([0.01, 0.0, 0.0]))
    sb = tfe.init_state()._replace(bias_gyr=torch.tensor([0.01, 0.0, 0.0]))
    pose = np.array([0.1, 0.0, 0.2, 1.0, 2.0, 3.0], np.float32)
    a = jfe.reinitialize(sa, jnp.asarray(pose))
    b = tfe.reinitialize(sb, t(pose))
    assert_state_close(b, a, atol=1e-6)
    np.testing.assert_array_equal(n(b.cov), n(a.cov))
