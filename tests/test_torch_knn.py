"""`lio_slam_tpu_torch.ops.knn` against `lio_slam_tpu.ops.knn` on the same
numpy inputs: the cases of tests/test_knn.py, each run through both.

Tolerances: squared distances within rtol 1e-5 of JAX's, relative to
‖q‖² + ‖r‖², the terms the distance is the difference of (the two
matmuls round q·r differently, and at small distances that difference is
all that is left); neighbour sets equal on at least 99 % of the queries
(ties may order differently); validity masks exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_helpers as H  # noqa: F401  (single-threaded torch)
from torch_port_helpers import n, t
from lio_slam_tpu.ops import knn as jknn
from lio_slam_tpu_torch.ops import knn as tknn


def both(q, qm, r, rm, **kw):
    j = jknn.knn(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r),
                 jnp.asarray(rm), **kw)
    p = tknn.knn(t(q), t(qm), t(r), t(rm), **kw)
    return j, p, q, r


def assert_same(j, p, q, r):
    np.testing.assert_array_equal(n(p.valid), n(j.valid))
    v = n(j.valid)
    scale = (q * q).sum(1)[:, None] + (r * r).sum(1)[n(j.idx)]
    err = np.abs(n(p.dist2) - n(j.dist2))
    assert (err[v] <= 1e-5 * scale[v]).all(), (err[v] / scale[v]).max()
    np.testing.assert_array_equal(n(p.dist2)[~v], n(j.dist2)[~v])
    same = [set(a[v]) == set(b[v]) for a, b, v in
            zip(n(p.idx), n(j.idx), n(j.valid))]
    assert np.mean(same) >= 0.99


@pytest.mark.parametrize("n_q,n_r,chunk,k", [(64, 500, 128, 5),
                                             (10, 100, 64, 1),
                                             (300, 4096, 1024, 5)])
def test_knn_matches_jax(n_q, n_r, chunk, k):
    rs = np.random.RandomState(n_q)
    q = rs.randn(n_q, 3).astype(np.float32)
    r = rs.randn(n_r, 3).astype(np.float32)
    qm = rs.rand(n_q) > 0.1
    rm = rs.rand(n_r) > 0.2
    assert_same(*both(q, qm, r, rm, k=k, chunk=chunk))


def test_knn_world_scale_cancellation_matches_jax():
    """At tens of metres q^2 + r^2 - 2 q.r cancels: the port keeps the
    reference's form, so distances differ from JAX's only by the rounding
    of q.r, and a neighbour set differs only where its last neighbour and
    the next candidate are that close (a near tie); the 5th neighbour's
    radius gate is JAX's."""
    rs = np.random.RandomState(3)
    r = (rs.uniform(-1, 1, (2048, 3)) * [2, 2, 0.5] + [40, -30, 1]).astype(np.float32)
    q = (r[:256] + rs.randn(256, 3) * 0.05).astype(np.float32)
    j, p, _, _ = both(q, np.ones(256, bool), r, np.ones(2048, bool), k=5,
                      chunk=512)
    scale = (q * q).sum(1) + (r * r).sum(1).max()
    err = np.abs(n(p.dist2) - n(j.dist2))
    assert (err <= 1e-5 * scale[:, None]).all()
    jd = n(j.dist2)
    for i in np.flatnonzero([set(a) != set(b) for a, b in zip(n(p.idx), n(j.idx))]):
        # the first candidate JAX left out is within the rounding band of
        # its 5th neighbour
        d_all = ((q[i] - r) ** 2).sum(1)
        outside = np.setdiff1d(np.arange(len(r)), n(j.idx)[i])
        assert d_all[outside].min() - jd[i, 4] <= 2e-5 * scale[i]
    same = [set(a) == set(b) for a, b in zip(n(p.idx), n(j.idx))]
    assert np.mean(same) >= 0.95
    np.testing.assert_array_equal(n(p.dist2[:, 4] < 1.0), jd[:, 4] < 1.0)


def test_knn_respects_ref_mask():
    q = np.zeros((4, 3), np.float32)
    r = np.concatenate([np.zeros((3, 3)), np.full((5, 3), 100.0)]).astype(np.float32)
    rm = np.array([False, False, False, True, True, True, True, True])
    out = both(q, np.ones(4, bool), r, rm, k=2, chunk=4)
    assert np.all(n(out[1].idx) >= 3)
    assert_same(*out)


def test_knn_invalid_query_and_few_refs():
    out = both(np.zeros((2, 3), np.float32), np.array([True, False]),
               np.zeros((8, 3), np.float32), np.ones(8, bool), k=3, chunk=8)
    assert n(out[1].valid)[0].all() and not n(out[1].valid)[1].any()
    assert_same(*out)
    rm = np.zeros(8, bool)
    rm[0] = True
    out = both(np.zeros((2, 3), np.float32), np.ones(2, bool),
               np.ones((8, 3), np.float32), rm, k=3, chunk=8)
    assert int(n(out[1].valid)[0].sum()) == 1
    assert_same(*out)


def test_knn_ties_keep_the_lower_index():
    """Equal distances: the lower reference index first, as `lax.top_k`."""
    r = np.zeros((12, 3), np.float32)
    r[:, 0] = [1, -1, 1, -1, 2, 2, -2, 3, 1, -1, 5, 6]
    q = np.zeros((1, 3), np.float32)
    j, p, _, _ = both(q, np.ones(1, bool), r, np.ones(12, bool), k=5, chunk=5)
    np.testing.assert_array_equal(n(p.idx), n(j.idx))


def test_radius_neighbors_mask():
    ref = np.array([[0, 0, 0], [3, 0, 0], [10, 0, 0]], np.float32)
    for query in (np.zeros(3, np.float32), np.array([6.5, 0, 0], np.float32)):
        m_j = jknn.radius_neighbors_mask(jnp.asarray(query), jnp.asarray(ref),
                                         jnp.ones(3, bool), 5.0)
        m_p = tknn.radius_neighbors_mask(t(query), t(ref), t(np.ones(3, bool)),
                                         5.0)
        np.testing.assert_array_equal(n(m_p), n(m_j))
