"""Keyframe store, Scan Context descriptors and the mapping step's state
surgery (pipeline/keyframes, ops/scancontext, pipeline/lio, convert) of the
port against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np

from torch_port_helpers import n, small_config, t
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.ops import scancontext as jsc
from lio_slam_tpu.pipeline import keyframes as jkf
from lio_slam_tpu.pipeline import lio as jlio
from lio_slam_tpu.utils import pointcloud as jpc
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch import convert
from lio_slam_tpu_torch.ops import scancontext as tsc
from lio_slam_tpu_torch.pipeline import keyframes as tkf
from lio_slam_tpu_torch.pipeline import lio as tlio
from lio_slam_tpu_torch.utils import pointcloud as tpc

JCFG = small_config(jax_config)
TCFG = small_config(port_config)


def assert_tree_close(port_tree, jax_tree, atol=0.0):
    for name in port_tree._fields:
        a, b = getattr(port_tree, name), getattr(jax_tree, name)
        if hasattr(a, "_fields"):
            assert_tree_close(a, b, atol)
            continue
        a, b = n(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if atol == 0.0 or a.dtype == bool or a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=atol, err_msg=name)


def test_scan_context_descriptor():
    rs = np.random.RandomState(0)
    xyz = np.concatenate([rs.uniform(-90, 90, (800, 2)),
                          rs.uniform(-3, 6, (800, 1))], 1).astype(np.float32)
    mask = rs.uniform(size=800) > 0.1
    da = jsc.make_descriptor(jnp.asarray(xyz), jnp.asarray(mask))
    db = tsc.make_descriptor(t(xyz), t(mask))
    np.testing.assert_allclose(n(db), n(da), atol=1e-6)
    np.testing.assert_allclose(n(tsc.ring_key(db)), n(jsc.ring_key(da)), atol=1e-6)
    ja, tb = jsc.empty_db(3), tsc.empty_db(3)
    for _ in range(4):                                   # past capacity
        ja, tb = jsc.add_descriptor(ja, da), tsc.add_descriptor(tb, db)
    assert_tree_close(tb, ja, atol=1e-6)


def test_keyframe_gate_and_store():
    rs = np.random.RandomState(1)
    ja, tb = jkf.empty_store(4, 64), tkf.empty_store(4, 64)
    for i, step in enumerate([0.0, 0.5, 1.2, 0.1, 0.3]):
        pose = np.array([0, 0, 0.1 * i * step, step * i, 0.1 * i, 0], np.float32)
        ga = jkf.should_add_keyframe(ja, jnp.asarray(pose), 0.2, 1.0)
        gb = tkf.should_add_keyframe(tb, t(pose), 0.2, 1.0)
        assert bool(gb) == bool(ga)
        xyz = rs.randn(80, 3).astype(np.float32)
        m = rs.uniform(size=80) > 0.2
        ja = jkf.add_keyframe(ja, jnp.asarray(pose), jnp.float32(i),
                              jpc.Cloud(xyz=jnp.asarray(xyz), mask=jnp.asarray(m)))
        tb = tkf.add_keyframe(tb, t(pose), t(np.float32(i)),
                              tpc.Cloud(xyz=t(xyz), mask=t(m)))
    assert_tree_close(tb, ja)
    np.testing.assert_allclose(n(tkf.transform_keyframe_clouds(tb)),
                               n(jkf.transform_keyframe_clouds(ja)), atol=1e-5)


def filled_state(seed=0):
    """A JAX LioState at capacity with chain, loop and GPS factors and
    pending loop constraints, as numpy leaves."""
    rs = np.random.RandomState(seed)
    st = jax.tree.map(np.array, jlio.init_state(JCFG))
    K = st.store.poses.shape[0]
    st.store.poses[:] = rs.randn(K, 6) * 0.1
    st.store.count[...] = K
    st.store.cloud_masks[:, :10] = True
    st.graph.poses[:] = st.store.poses
    st.graph.pose_mask[:] = True
    st.graph.prior_info[:] = [100, 100, 1, 1e-8, 1e-8, 1e-8]
    st.graph.bt_i[:K - 1] = np.arange(K - 1)
    st.graph.bt_j[:K - 1] = np.arange(1, K)
    st.graph.bt_info[:K - 1] = 1e4
    st.graph.bt_mask[:K - 1] = True
    st.graph.bt_i[K - 1], st.graph.bt_j[K - 1] = 0, 5          # a loop on x0
    st.graph.bt_i[K], st.graph.bt_j[K] = 3, 9
    st.graph.bt_mask[K - 1:K + 1] = True
    st.graph.gps_i[:2] = [0, 4]
    st.graph.gps_mask[:2] = True
    st.sc_db.count[...] = K
    st.pend_i[:2], st.pend_j[:2] = [2, 0], [7, 6]
    st.pend_mask[:2] = True
    st.pend_meas[:2] = rs.randn(2, 6) * 0.1
    st.pend_info[:2] = 10.0
    return st


def test_init_state_layout_matches():
    jst = jax.tree.map(np.asarray, jlio.init_state(JCFG))
    assert_tree_close(tlio.init_state(TCFG), jst)


def test_evict_and_consume_pending_loops():
    st = filled_state()
    ja = jax.tree.map(jnp.asarray, st)
    tb = convert.from_numpy(st)
    ea, eb = jlio._evict_oldest(ja), tlio._evict_oldest(tb)
    assert_tree_close(eb, jax.tree.map(np.asarray, ea))
    ca = jlio._consume_pending_loops(ea, JCFG)
    cb = tlio._consume_pending_loops(eb, TCFG)
    assert_tree_close(cb, jax.tree.map(np.asarray, ca))


def test_update_initial_guess():
    st = filled_state()
    inp = dict(init_guess=np.array([0.1, 0.2, 0.3, 1, 2, 3], np.float32),
               imu_rpy=np.array([0.05, -0.04, 0.7], np.float32))
    for count in (0, 5):
        for valid in (True, False):
            st.store.count[...] = count
            ja = jax.tree.map(jnp.asarray, st)
            tb = convert.from_numpy(st)
            ia = jlio.empty_scan_input(8)._replace(
                init_guess=jnp.asarray(inp["init_guess"]),
                guess_valid=jnp.asarray(valid), imu_rpy=jnp.asarray(inp["imu_rpy"]),
                imu_available=jnp.asarray(True))
            ib = tlio.ScanInput(cloud=None, stamp=None,
                                init_guess=t(inp["init_guess"]),
                                guess_valid=t(np.bool_(valid)),
                                imu_rpy=t(inp["imu_rpy"]),
                                imu_available=t(np.bool_(True)),
                                gps_pos=None, gps_info=None, gps_valid=None)
            np.testing.assert_array_equal(n(tlio._update_initial_guess(tb, ib)),
                                          n(jlio._update_initial_guess(ja, ia)))


def test_convert_round_trip():
    st = filled_state(3)
    port = convert.from_numpy(st)
    back = convert.to_numpy(port)
    assert_tree_close(convert.from_numpy(back), st)
    from lio_slam_tpu.pipeline import imu_frontend as jfe
    imu = convert.from_numpy(jax.tree.map(np.asarray, jfe.init_state()))
    assert imu.nav.R.shape == (3, 3) and imu.cov.shape == (15, 15)
