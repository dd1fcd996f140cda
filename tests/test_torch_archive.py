"""The keyframe archive of the port against the JAX package (mirrors
tests/test_archive.py).

- The host archive (`KeyframeArchive`, its helpers) on the same seeded
  inputs in both packages: matches, poses, submaps and sidecar files equal
  (the same numpy code), sidecars loading across packages.
- The verifier on one state carried from the JAX package: the same gate
  decision, fitness within 2e-3 (a float32 GN run, the loop verification's
  tolerance in tests/test_torch_runner.py), the same queue and anchor
  slots.
- The Runner's archive in the port alone, with the JAX tests' assertions:
  a stale sidecar reconciled on resume and a deep gap rebuilt from the
  state.  The two 60-scan circuits (the anchor beside live GPS factors,
  the cross-eviction loop) are in tests/test_torch_archive_missions.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.ops import scancontext as jsc
from lio_slam_tpu.pipeline import archive as jarch
from lio_slam_tpu.pipeline import lio as jlio
from lio_slam_tpu.utils import pointcloud as jpc
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch import convert
from lio_slam_tpu_torch.config import (Config, KeyframeConfig,
                                       LoopClosureConfig, RegistrationConfig,
                                       StaticConfig)
from lio_slam_tpu_torch.io import formats, synthetic
from lio_slam_tpu_torch.ops import scancontext as tsc
from lio_slam_tpu_torch.pipeline import archive as tarch
from lio_slam_tpu_torch.pipeline.runner import Runner
from lio_slam_tpu_torch.utils import se3


def mk_archive(mod, n_kf=10, evicted=6, seed=0):
    rs = np.random.RandomState(seed)
    a = mod.KeyframeArchive(num_ring=4, num_sector=8)
    descs = rs.rand(n_kf, 4, 8).astype(np.float32) + 0.1
    for i in range(n_kf):
        pose = np.array([0, 0, 0.1 * i, float(i), 0, 0], np.float32)
        a.add(i, pose, stamp=float(i), cloud=rs.randn(50, 3).astype(np.float32),
              descriptor=descs[i])
    a.evict_count = evicted
    return a, descs


def set_query(a, desc):
    a.descriptors[-1] = desc.copy()
    a._ring_keys[-1] = desc.mean(axis=-1)


class TestArchiveCore:
    def test_add_requires_order(self):
        a, _ = mk_archive(tarch, 3, 0)
        with pytest.raises(ValueError):
            a.add(5, np.zeros(6), 0.0, np.zeros((1, 3)), np.zeros((4, 8)))
        a.add(1, np.zeros(6), 0.0, np.zeros((1, 3)), np.zeros((4, 8)))  # dup ok
        assert len(a) == 3 and a.num_points == 150

    @pytest.mark.parametrize("twin,time_diff,thresh", [
        (2, 3.0, 0.2),        # an evicted twin: found, yaw 0
        (7, 3.0, 0.05),       # a LIVE twin: the device detector's job, no match
        (5, 100.0, 0.05),     # too recent
        (None, 3.0, 0.5)])    # no twin: the best evicted candidate under 0.5
    def test_match_equals_jax(self, twin, time_diff, thresh):
        ta, descs = mk_archive(tarch)
        ja, _ = mk_archive(jarch)
        if twin is not None:
            set_query(ta, descs[twin])
            set_query(ja, descs[twin])
        hb = ta.match(now=9.0, time_diff=time_diff, dist_thresh=thresh)
        hj = ja.match(now=9.0, time_diff=time_diff, dist_thresh=thresh)
        assert hb == hj
        if twin == 2:
            assert hb[0] == 2 and hb[2] < 1e-5 and abs(hb[1]) < 1e-6
        if twin in (7, 5):
            assert hb is None

    @pytest.mark.parametrize("shift", [2, -3])
    def test_match_yaw_convention(self, shift):
        """A query that is the candidate column-rolled matches the yaw sign
        of scancontext.detect, in the port and in the JAX package."""
        a, descs = mk_archive(tarch)
        rolled = np.roll(descs[2], shift, axis=-1)
        set_query(a, rolled)
        gid, yaw, _ = a.match(now=9.0, time_diff=3.0, dist_thresh=0.2)
        assert gid == 2
        tdb, jdb = tsc.empty_db(10, 4, 8), jsc.empty_db(10, 4, 8)
        for i in range(7):
            tdb = tsc.add_descriptor(tdb, t(descs[i]))
            jdb = jsc.add_descriptor(jdb, jnp.asarray(descs[i]))
        tm = tsc.detect(tdb, t(rolled), dist_threshold=0.2, num_candidates=3,
                        exclude_recent=4)
        jm = jsc.detect(jdb, jnp.asarray(rolled), dist_threshold=0.2,
                        num_candidates=3, exclude_recent=4)
        assert int(tm.index) == int(jm.index) == 2
        assert yaw == pytest.approx(float(tm.yaw), abs=1e-5)
        assert yaw == pytest.approx(float(jm.yaw), abs=1e-5)

    def test_sc_distance_equals_device_version(self):
        rs = np.random.RandomState(4)
        q = rs.rand(4, 8).astype(np.float32)
        q[:, 3] = 0.0                        # an empty column
        c = rs.rand(3, 4, 8).astype(np.float32)
        hb = tarch._sc_distance_all_shifts_np(q, c)
        np.testing.assert_array_equal(hb, jarch._sc_distance_all_shifts_np(q, c))
        np.testing.assert_allclose(hb, n(tsc._sc_distance_all_shifts(t(q), t(c))),
                                   atol=1e-6)

    def test_refresh_live_poses_and_submap_equal_jax(self):
        ta, _ = mk_archive(tarch)
        ja, _ = mk_archive(jarch)
        live = np.tile(np.array([0, 0, 0, 0, 99.0, 0], np.float32), (4, 1))
        for a in (ta, ja):
            a.refresh_live_poses(6, live, 4)
        assert ta.poses[7][4] == 99.0 and ta.poses[5][4] == 0.0
        for gid, k, cap in ((2, 1, 1000), (8, 2, 1000), (5, 3, 64)):
            pb, pj = ta.submap(gid, k, cap), ja.submap(gid, k, cap)
            np.testing.assert_array_equal(pb, pj)
        assert ta.submap(2, 1, 1000).shape == (150, 3)
        assert abs(ta.submap(2, 1, 1000)[:, 0].mean() - 2.0) < 0.5

    def test_sidecars_load_across_packages(self, tmp_path):
        ta, descs = mk_archive(tarch)
        ja, _ = mk_archive(jarch)
        pb, pj = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
        ta.save(pb)
        ja.save(pj)
        for path in (pb, pj):
            for mod in (tarch, jarch):
                b = mod.KeyframeArchive.load(path)
                assert len(b) == 10 and b.evict_count == 6 and b.base_gid == 0
                np.testing.assert_array_equal(b.descriptors[3], descs[3])
                np.testing.assert_array_equal(b.clouds[4], ta.clouds[4])
                np.testing.assert_array_equal(b.poses[9], ta.poses[9])
                assert b.stamps == ta.stamps

    def test_base_gid_addressing(self):
        a = tarch.KeyframeArchive(num_ring=4, num_sector=8, base_gid=5)
        rs = np.random.RandomState(1)
        for i in range(5, 9):
            a.add(i, np.array([0, 0, 0, float(i), 0, 0], np.float32),
                  float(i), rs.randn(10, 3).astype(np.float32),
                  rs.rand(4, 8).astype(np.float32))
        a.evict_count = 7
        a.refresh_live_poses(7, np.tile(np.array([0, 0, 0, 0, 5.0, 0],
                                                 np.float32), (2, 1)), 2)
        assert a.poses[2][4] == 5.0          # gid 7 = local 2
        assert a.poses[0][4] == 0.0          # gid 5 frozen
        assert abs(a.submap(6, search_num=0, max_points=100)[:, 0].mean() - 6.0) < 1.0

    @pytest.mark.parametrize("yaw", [-0.5, 3.0])
    def test_compose_yaw_equals_se3_and_jax(self, yaw):
        pose = np.array([0.1, -0.2, 0.7, 1.0, 2.0, 3.0], np.float32)
        host = tarch.compose_yaw_np(pose, yaw)
        np.testing.assert_array_equal(host, jarch.compose_yaw_np(pose, yaw))
        dev = se3.pose6_compose(t(pose), t(np.array([0, 0, yaw, 0, 0, 0],
                                                    np.float32))).numpy()
        np.testing.assert_allclose(host, dev, atol=1e-5)
        Rh, th = tarch._pose6_to_Rt_np(pose)
        Rd, td = se3.pose6_to_Rt(t(pose))
        np.testing.assert_allclose(Rh, n(Rd), atol=1e-6)
        np.testing.assert_array_equal(th, n(td))


def cfg_small(m, **kw):
    """The configuration of tests/test_checkpoint.py with the archive on."""
    return m.Config(
        static=m.StaticConfig(max_raw_points=2048, max_scan_points=2048,
                              max_map_points=8192, max_keyframes=16,
                              max_keyframe_points=1024, max_loop_queue=2,
                              max_gps_queue=2, window_size=8,
                              max_archive_anchors=2),
        registration=m.RegistrationConfig(degeneracy_eig_thresh=10.0), **kw)


@pytest.fixture(scope="module")
def carried():
    """Eleven JAX mapping steps of the circuit (five keyframes), as numpy
    leaves, and the world points of their keyframes: the 'archived
    submap'.  (On the straight corridor of seed 0 the verification's strict
    `converged` flag never rises within 30 GN iterations.)"""
    cfg = cfg_small(jax_config)
    seq = circuit_seq(11)
    step = jlio.make_lio_step(cfg)
    state = jlio.init_state(cfg)
    for i in range(11):
        inp = jlio.ScanInput(
            cloud=jpc.Cloud(xyz=jnp.asarray(seq.scans[i]),
                            mask=jnp.asarray(seq.scan_masks[i])),
            stamp=jnp.float32(seq.stamps[i]),
            init_guess=jnp.asarray(np.zeros(6, np.float32)),
            guess_valid=jnp.asarray(False), imu_rpy=jnp.asarray(seq.imu_rpy[i]),
            imu_available=jnp.asarray(True), gps_pos=jnp.zeros(3),
            gps_info=jnp.zeros(3), gps_valid=jnp.asarray(False))
        state, _ = step(state, inp)
    st = jax.tree.map(np.array, state)
    cnt = int(st.store.count)
    assert cnt == 5
    R, tr = se3.pose6_to_Rt(t(st.store.poses[:cnt]))
    world = (torch.einsum("kij,kpj->kpi", R, t(st.store.clouds[:cnt]))
             + tr[:, None, :]).numpy()[st.store.cloud_masks[:cnt]]
    cap = cfg.static.max_map_points
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:len(world)] = world[:cap]
    return st, xyz, np.arange(cap) < len(world)


def full_anchor_region(st, G):
    """The state with both anchor slots taken (endpoints 2 and 1)."""
    g = st.graph
    mask, gi = g.gps_mask.copy(), g.gps_i.copy()
    mask[G - 2:] = True
    gi[G - 2:] = [2, 1]
    return st._replace(graph=g._replace(gps_mask=mask, gps_i=gi))


@pytest.mark.parametrize("case", ["free", "anchors_full", "queue_full", "wander"])
def test_verifier_equals_jax(carried, case):
    st, xyz, mask = carried
    G = st.graph.gps_mask.shape[0]
    if case == "anchors_full":
        st = full_anchor_region(st, G)
    if case == "queue_full":
        st = st._replace(pend_mask=np.ones_like(st.pend_mask))
    cur = int(st.store.count) - 1
    init = st.store.poses[cur] + np.array([0, 0, 0.01, 0.1, -0.05, 0], np.float32)
    max_wander = 1e-4 if case == "wander" else 5.0
    jout = jarch.make_archive_verifier(cfg_small(jax_config))(
        jax.tree.map(jnp.asarray, st), jnp.asarray(xyz), jnp.asarray(mask),
        jnp.asarray(init), np.float32(max_wander))
    tout = tarch.make_archive_verifier(cfg_small(port_config))(
        convert.from_numpy(st), t(xyz), t(mask), t(init), max_wander)
    (ja, jadd, jfit), (tb, tadd, tfit) = jout, tout
    assert bool(tadd) == bool(jadd) == (case in ("free", "anchors_full"))
    assert abs(float(tfit) - float(jfit)) < 2e-3 and float(tfit) < 0.3
    for name in ("pend_i", "pend_j", "pend_mask"):
        np.testing.assert_array_equal(n(getattr(tb, name)), n(getattr(ja, name)),
                                      err_msg=name)
    for name in ("gps_i", "gps_mask"):
        np.testing.assert_array_equal(n(getattr(tb.graph, name)),
                                      n(getattr(ja.graph, name)), err_msg=name)
    np.testing.assert_allclose(n(tb.pend_meas), n(ja.pend_meas), atol=2e-3)
    np.testing.assert_allclose(n(tb.graph.gps_meas), n(ja.graph.gps_meas), atol=2e-3)
    assert int(tb.gps_count) == int(ja.gps_count) == 0
    if case == "anchors_full":
        # the anchor with the oldest endpoint (keyframe 1) was recycled
        assert n(tb.graph.gps_i)[G - 1] == cur and n(tb.graph.gps_i)[G - 2] == 2


def test_kf_snapshot_is_fresh(carried):
    st = convert.from_numpy(carried[0])
    snap = tarch.make_kf_snapshot()(st)
    cur = int(st.store.count) - 1
    np.testing.assert_array_equal(n(snap["arch_pose"]), n(st.store.poses[cur]))
    np.testing.assert_array_equal(n(snap["arch_desc"]), n(st.sc_db.descriptors[cur]))
    assert int(snap["arch_kf_count"]) == cur + 1 and int(snap["arch_evict_count"]) == 0
    state_ptrs = {x.untyped_storage().data_ptr() for x in
                  (st.store.poses, st.store.stamps, st.store.clouds,
                   st.store.cloud_masks, st.sc_db.descriptors, st.store.count,
                   st.evict_count)}
    assert not state_ptrs & {v.untyped_storage().data_ptr() for v in snap.values()}


# -- the Runner's archive, the port alone ------------------------------------

def circuit_cfg(**kw):
    """The JAX test's `_circuit_cfg`: an 8-keyframe store, a 0.6 m keyframe
    spacing, no archive cooldown."""
    return Config(
        static=StaticConfig(max_raw_points=2048, max_scan_points=2048,
                            max_map_points=8192, max_keyframes=8,
                            max_keyframe_points=1024, max_loop_queue=2,
                            max_gps_queue=2, window_size=8, max_imu_window=32),
        registration=RegistrationConfig(degeneracy_eig_thresh=10.0),
        keyframe=KeyframeConfig(dist_threshold=0.6),
        loop=LoopClosureConfig(enabled=True, time_diff=1.5,
                               archive_cooldown_s=0.0, search_num=3,
                               sc_dist_thresh=0.35), **kw)


def circuit_seq(n_scans):
    # one 45-scan lap (r ~= 1.4 m, ~15 keyframes at the 0.6 m gate: twice
    # the 8-keyframe device capacity)
    return synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=3,
                                   speed=2.0, yaw_rate=2 * np.pi / 4.5)


def scan_at(seq, i):
    m = seq.scan_masks[i]
    k = int(m.sum())
    return formats.StandardScan(
        xyz=seq.scans[i][m], intensity=np.zeros(k, np.float32),
        ring=np.zeros(k, np.uint16), time=np.zeros(k, np.float32),
        stamp=float(seq.stamps[i]))


def imu_at(seq, i, cfg):
    if i == 0:
        return None
    inc = se3.pose6_between(t(seq.poses[i - 1]), t(seq.poses[i])).numpy()
    T = 8
    t0, t1 = float(seq.stamps[i - 1]), float(seq.stamps[i])
    return {"acc": np.tile([0, 0, cfg.imu.gravity], (T, 1)).astype(np.float32),
            "gyr": np.tile(inc[:3] / (t1 - t0), (T, 1)).astype(np.float32),
            "stamps": np.linspace(t0, t1, T + 1)[1:]}


def feed(runner, seq, lo, hi, imu=False, fixes=None):
    for i in range(lo, hi):
        runner.process_scan(scan_at(seq, i),
                            imu=imu_at(seq, i, runner.cfg) if imu else None,
                            gps_fix=None if fixes is None else fixes[i])


def test_stale_sidecar_reconciles_on_resume(tmp_path):
    """A sidecar that lags the checkpoint (a crash between the two saves)
    is topped up from the restored store, and the archive keeps growing."""
    cfg = circuit_cfg()
    seq = circuit_seq(16)
    ck = str(tmp_path / "ck.npz")
    runner = Runner(cfg, device="cpu", loop_every=100)
    feed(runner, seq, 0, 12)
    runner.save_checkpoint(ck)
    n_full = len(runner._archive)
    assert n_full >= 2
    a = tarch.KeyframeArchive.load(ck + ".archive.npz")
    for lst in (a.poses, a.stamps, a.clouds, a.descriptors, a._ring_keys):
        del lst[-2:]
    a.save(ck + ".archive.npz")
    r2 = Runner(cfg, device="cpu", loop_every=100)
    r2.load_checkpoint(ck)
    assert len(r2._archive) == n_full
    feed(r2, seq, 12, 16)
    r2.drain()
    assert len(r2._archive) >= n_full
    assert (r2._archive.base_gid + len(r2._archive)
            == int(r2.state.evict_count) + int(r2.state.store.count))
    assert r2.archive_gaps == 0


def test_sidecar_deep_gap_rebuilds_from_state(tmp_path):
    """A sidecar missing device-EVICTED keyframes cannot be repaired: the
    archive is rebuilt from the live store, base_gid marks the loss and
    health() reports it."""
    cfg = circuit_cfg()
    seq = circuit_seq(40)
    ck = str(tmp_path / "ck.npz")
    runner = Runner(cfg, device="cpu", loop_every=100)
    feed(runner, seq, 0, 40)
    runner.drain()
    assert int(runner.state.evict_count) > 0, "test needs evictions"
    runner.save_checkpoint(ck)
    a = tarch.KeyframeArchive.load(ck + ".archive.npz")
    for lst in (a.poses, a.stamps, a.clouds, a.descriptors, a._ring_keys):
        del lst[1:]
    a.evict_count = 0
    a.save(ck + ".archive.npz")
    r2 = Runner(cfg, device="cpu", loop_every=100)
    r2.load_checkpoint(ck)
    assert r2.archive_gaps == 1 and r2.health()["archive_gaps"] == 1
    assert r2._archive.base_gid == int(r2.state.evict_count)
    assert len(r2._archive) == int(r2.state.store.count)
    # without a sidecar the store is all there is, and nothing is a gap
    os.remove(ck + ".archive.npz")
    r3 = Runner.resume(ck, cfg, device="cpu", loop_every=100)
    assert r3.archive_gaps == 0 and r3._archive.base_gid == int(r3.state.evict_count)
