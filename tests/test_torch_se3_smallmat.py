"""utils/se3 and utils/smallmat of the port against the JAX package
(float32 on both sides; tolerances are a few float32 ulps of the values)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from torch_port_helpers import n, t
from lio_slam_tpu.utils import se3 as J
from lio_slam_tpu.utils import smallmat as JS
from lio_slam_tpu_torch.utils import se3 as T
from lio_slam_tpu_torch.utils import smallmat as TS

RS = np.random.RandomState(0)
VEC3 = np.concatenate([RS.randn(16, 3) * 0.7,
                       RS.randn(4, 3) * 1e-5,             # small-angle branch
                       np.array([[np.pi - 1e-4, 0, 0]])]).astype(np.float32)
RPY = (RS.uniform(-1, 1, (16, 3)) * [1.0, 0.7, 3.0]).astype(np.float32)
POSE6 = np.concatenate([RPY, RS.randn(16, 3) * 5], 1).astype(np.float32)


@pytest.mark.parametrize("fn", ["skew", "so3_exp", "so3_left_jacobian",
                                "so3_right_jacobian", "rpy_to_matrix"])
def test_vec3_functions(fn):
    np.testing.assert_allclose(n(getattr(T, fn)(t(VEC3))),
                               n(getattr(J, fn)(jnp.asarray(VEC3))),
                               atol=2e-6)


def test_so3_log_roundtrip_and_match():
    R = n(J.so3_exp(jnp.asarray(VEC3)))
    np.testing.assert_allclose(n(T.so3_log(t(R))), n(J.so3_log(jnp.asarray(R))),
                               atol=5e-5)


def test_euler_quat_conversions():
    R = n(J.rpy_to_matrix(jnp.asarray(RPY)))
    np.testing.assert_allclose(n(T.matrix_to_rpy(t(R))),
                               n(J.matrix_to_rpy(jnp.asarray(R))), atol=2e-6)
    q = n(J.matrix_to_quat(jnp.asarray(R)))
    np.testing.assert_allclose(n(T.matrix_to_quat(t(R))), q, atol=2e-6)
    np.testing.assert_allclose(n(T.quat_to_matrix(t(q))),
                               n(J.quat_to_matrix(jnp.asarray(q))), atol=2e-6)
    q2 = q[::-1].copy()
    np.testing.assert_allclose(n(T.quat_mul(t(q), t(q2))),
                               n(J.quat_mul(jnp.asarray(q), jnp.asarray(q2))),
                               atol=2e-6)
    np.testing.assert_allclose(n(T.slerp(t(q), t(q2), 0.3)),
                               n(J.slerp(jnp.asarray(q), jnp.asarray(q2), 0.3)),
                               atol=5e-6)


def test_se3_exp_log_compose():
    xi = np.concatenate([VEC3[:16], RS.randn(16, 3)], 1).astype(np.float32)
    Rt, tt = T.se3_exp(t(xi))
    Rj, tj = J.se3_exp(jnp.asarray(xi))
    np.testing.assert_allclose(n(Rt), n(Rj), atol=2e-6)
    np.testing.assert_allclose(n(tt), n(tj), atol=5e-6)
    np.testing.assert_allclose(n(T.se3_log(Rt, tt)), n(J.se3_log(Rj, tj)),
                               atol=5e-5)
    a, b = POSE6, POSE6[::-1].copy()
    for fn in ("pose6_compose", "pose6_between"):
        np.testing.assert_allclose(n(getattr(T, fn)(t(a), t(b))),
                                   n(getattr(J, fn)(jnp.asarray(a), jnp.asarray(b))),
                                   atol=2e-5)
    np.testing.assert_allclose(n(T.pose6_inverse(t(a))),
                               n(J.pose6_inverse(jnp.asarray(a))), atol=2e-5)
    R, tr = T.pose6_to_Rt(t(a))
    pts = RS.randn(16, 7, 3).astype(np.float32)
    Rj, trj = J.pose6_to_Rt(jnp.asarray(a))
    np.testing.assert_allclose(n(T.transform_points(R, tr, t(pts))),
                               n(J.transform_points(Rj, trj, jnp.asarray(pts))),
                               atol=2e-5)


def test_closed_form_rotation_jacobian():
    """dR/dθ in closed form equals torch.func.jacfwd and jax.jacfwd."""
    for rpy in RPY[:6]:
        closed = n(T.rpy_to_matrix_jacobian(t(rpy)))
        np.testing.assert_allclose(closed, n(jacfwd(T.rpy_to_matrix)(t(rpy))),
                                   atol=1e-6)
        np.testing.assert_allclose(closed,
                                   n(jax.jacfwd(J.rpy_to_matrix)(jnp.asarray(rpy))),
                                   atol=1e-6)
    batched = n(T.rpy_to_matrix_jacobian(t(RPY)))
    assert batched.shape == (16, 3, 3, 3)
    np.testing.assert_allclose(batched[3], n(T.rpy_to_matrix_jacobian(t(RPY[3]))))


def _spd(k, scale=1.0):
    A = RS.randn(k, 6, 6).astype(np.float32)
    return (A @ A.transpose(0, 2, 1) * scale + np.eye(6, dtype=np.float32)).astype(np.float32)


def test_cholesky_solve():
    A = _spd(5)
    b = RS.randn(5, 6).astype(np.float32)
    np.testing.assert_allclose(n(TS.cholesky_solve(t(A), t(b), eps=1e-6)),
                               n(JS.cholesky_solve(jnp.asarray(A), jnp.asarray(b), eps=1e-6)),
                               rtol=1e-5, atol=1e-5)
    B = RS.randn(5, 6, 3).astype(np.float32)
    np.testing.assert_allclose(n(TS.cholesky_solve_mat(t(A), t(B))),
                               n(JS.cholesky_solve_mat(jnp.asarray(A), jnp.asarray(B))),
                               rtol=1e-5, atol=1e-5)


def test_eigh_jacobi():
    for A in _spd(3, scale=100.0):
        wt, Vt = TS.eigh_jacobi(t(A))
        wj, Vj = JS.eigh_jacobi(jnp.asarray(A))
        np.testing.assert_allclose(n(wt), n(wj), rtol=1e-5, atol=1e-4)
        # eigenvectors up to sign
        dots = np.abs(np.sum(n(Vt) * n(Vj), axis=0))
        np.testing.assert_allclose(dots, 1.0, atol=1e-4)
        np.testing.assert_allclose(n(Vt) @ np.diag(n(wt)) @ n(Vt).T, A,
                                   rtol=1e-4, atol=1e-3)


def test_rotation_ops_on_float32_only():
    assert T.so3_exp(t(VEC3)).dtype == torch.float32
    assert T.rpy_to_matrix_jacobian(t(RPY)).dtype == torch.float32
