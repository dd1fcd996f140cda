"""Loop closure of the port against the JAX package: Scan Context retrieval
(ops/scancontext), the submap and the detector (pipeline/loop_closure), the
rebuild-form `register` (ops/registration), the loop factor's way into the
graph and the full correction (pipeline/lio).

Tolerances: descriptor distances within 1e-5, the matched index and yaw
identical; submap clouds within 1e-5 m; `register` the same number of GN
iterations and inliers and a pose within 1e-4; the circle mission step for
step: identical keyframe flags, detector decisions, matched pairs, pending
queue and graph slots, poses within 2e-3 before and 5e-3 after the full
correction (both run float32; measured values are in the tests).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (jax_fused_interpret, n, planar_scene, t,
                                to_jax_config)
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.io import synthetic as jsynthetic
from lio_slam_tpu.ops import registration as jreg
from lio_slam_tpu.ops import scancontext as jsc
from lio_slam_tpu.pipeline import lio as jlio
from lio_slam_tpu.pipeline import loop_closure as jloop
from lio_slam_tpu.utils import pointcloud as jpc
from lio_slam_tpu.utils import se3 as jse3
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch import convert
from lio_slam_tpu_torch.ops import registration as treg
from lio_slam_tpu_torch.ops import scancontext as tsc
from lio_slam_tpu_torch.pipeline import lio as tlio
from lio_slam_tpu_torch.pipeline import loop_closure as tloop
from lio_slam_tpu_torch.utils import pointcloud as tpc


def loop_config(m):
    """The configuration of tests/test_loop_closure.py."""
    return m.Config(
        static=m.StaticConfig(
            max_raw_points=4096, max_scan_points=4096, max_map_points=16384,
            max_keyframes=64, max_keyframe_points=2048,
            max_loop_queue=4, max_gps_queue=4, window_size=16,
            icp_submap_points=8192),
        registration=m.RegistrationConfig(degeneracy_eig_thresh=10.0),
        loop=m.LoopClosureConfig(time_diff=2.0, sc_exclude_recent=4,
                                 search_radius=5.0, search_num=3,
                                 fitness_score=0.3))


# --------------------------------------------------------------------------
# Scan Context retrieval
# --------------------------------------------------------------------------

def yawed(xyz, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return (xyz @ R.T).astype(np.float32)


def place(seed, n_pts=3000):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(-60, 60, (n_pts, 2))
    z = 2.0 * np.sin(xy[:, :1] * 0.11 + seed) + rs.uniform(0, 4, (n_pts, 1)) \
        * (rs.uniform(size=(n_pts, 1)) > 0.7)
    return np.concatenate([xy, z], 1).astype(np.float32)


def test_sc_distance_all_shifts_matches():
    rs = np.random.RandomState(0)
    q = rs.uniform(0, 5, (20, 60)).astype(np.float32)
    q[:, rs.permutation(60)[:7]] = 0.0                    # empty columns
    cands = rs.uniform(0, 5, (3, 20, 60)).astype(np.float32)
    cands[1] = np.roll(q, 11, axis=1)
    cands[2, :, ::3] = 0.0
    a = n(jsc._sc_distance_all_shifts(jnp.asarray(q), jnp.asarray(cands)))
    b = n(tsc._sc_distance_all_shifts(t(q), t(cands)))
    assert b.shape == (3, 60)
    np.testing.assert_allclose(b, a, atol=1e-5)
    assert b[1].min() < 1e-5 and b[1].argmin() == np.abs(a[1]).argmin()


def filled_dbs(n_places=12):
    ja, tb = jsc.empty_db(16), tsc.empty_db(16)
    clouds = [place(s) for s in range(n_places)]
    for c in clouds:
        m = np.ones(len(c), bool)
        ja = jsc.add_descriptor(ja, jsc.make_descriptor(jnp.asarray(c),
                                                        jnp.asarray(m)))
        tb = tsc.add_descriptor(tb, tsc.make_descriptor(t(c), t(m)))
    return clouds, ja, tb


@pytest.mark.parametrize("revisit,yaw_deg", [(2, 0.0), (3, 48.0), (5, -120.0),
                                             (1, 174.0)])
def test_detect_yawed_revisit_matches(revisit, yaw_deg):
    clouds, ja, tb = filled_dbs()
    rs = np.random.RandomState(revisit)
    # the query sensor is yawed by +yaw: it sees the place rotated by -yaw
    q = yawed(clouds[revisit], -np.radians(yaw_deg)) \
        + rs.randn(len(clouds[revisit]), 3).astype(np.float32) * 0.02
    m = np.ones(len(q), bool)
    qa = jsc.make_descriptor(jnp.asarray(q), jnp.asarray(m))
    qb = tsc.make_descriptor(t(q), t(m))
    a = jsc.detect(ja, qa, dist_threshold=0.3, num_candidates=3, exclude_recent=4)
    b = tsc.detect(tb, qb, dist_threshold=0.3, num_candidates=3, exclude_recent=4)
    assert int(b.index) == int(a.index) == revisit
    assert b.index.dtype == torch.int32
    np.testing.assert_allclose(float(b.distance), float(a.distance), atol=1e-5)
    np.testing.assert_allclose(float(b.yaw), float(a.yaw), atol=1e-6)
    # 6-degree sectors: the yaw guess is within one sector of the truth
    err = (float(b.yaw) - np.radians(yaw_deg) + np.pi) % (2 * np.pi) - np.pi
    assert abs(err) <= np.radians(6.0) + 1e-6
    assert -np.pi <= float(b.yaw) <= np.pi


def test_detect_rejects_recent_and_unknown_places():
    clouds, ja, tb = filled_dbs()
    m = np.ones(3000, bool)
    # place 10 is among the 4 most recent of 12: excluded
    for q in (clouds[10], place(99)):
        a = jsc.detect(ja, jsc.make_descriptor(jnp.asarray(q), jnp.asarray(m)),
                       dist_threshold=0.05, num_candidates=3, exclude_recent=4)
        b = tsc.detect(tb, tsc.make_descriptor(t(q), t(m)),
                       dist_threshold=0.05, num_candidates=3, exclude_recent=4)
        assert int(b.index) == int(a.index) == -1
        assert float(b.yaw) == float(a.yaw) == 0.0
        np.testing.assert_allclose(float(b.distance), float(a.distance), atol=1e-5)
    # an empty database: every row ineligible, no match, nothing raised
    b = tsc.detect(tsc.empty_db(16), tsc.make_descriptor(t(clouds[0]), t(m)))
    assert int(b.index) == -1 and np.isinf(float(b.distance))


# --------------------------------------------------------------------------
# the rebuild-form register
# --------------------------------------------------------------------------

@pytest.mark.parametrize("refresh,n_scan,halo,sort", [
    pytest.param(1, 640, "z", False, id="1-640"),
    pytest.param(2, 896, "z", False, id="2-896"),
    pytest.param(2, 768, "full", True, id="2-768-full-sorted")])
def test_register_matches(monkeypatch, refresh, n_scan, halo, sort):
    """JAX through its fused path (the Pallas kernel in interpret mode, as
    off the CPU; it takes scans of a multiple of 128 points), the port
    through the fused pass's plain version.  The scan sizes are this test's
    own, so no other test's compiled `register` is reused.  The last case
    builds the "full" grid over the map and sorts the scan by cell."""
    monkeypatch.setattr(jreg, "_maybe_fused", jax_fused_interpret)
    map_pts, scan = planar_scene(5, n_map=4096, n_scan=n_scan)
    mmask = np.ones(len(map_pts), bool)
    mmask[::9] = False
    smask = np.ones(n_scan, bool)
    smask[::11] = False
    init = np.array([0.01, -0.02, 0.05, 0.3, -0.2, 0.05], np.float32)
    kw = dict(corr_refresh_every=refresh, grid_table_size=4096,
              grid_halo=halo, grid_max_per_cell=128 if halo == "full" else 24,
              sort_scan_by_cell=sort)
    ra = jreg.register(jnp.asarray(scan), jnp.asarray(smask), jnp.asarray(map_pts),
                       jnp.asarray(mmask), jnp.asarray(init),
                       jax_config.RegistrationConfig(**kw))
    rb = treg.register(t(scan), t(smask), t(map_pts), t(mmask), t(init),
                       port_config.RegistrationConfig(**kw))
    assert rb.iterations == int(ra.iterations) > 1
    assert rb.converged == bool(ra.converged)
    assert int(rb.num_inliers) == int(ra.num_inliers) > 100
    np.testing.assert_allclose(n(rb.pose), n(ra.pose), atol=1e-4)
    np.testing.assert_allclose(float(rb.mean_residual), float(ra.mean_residual),
                               rtol=1e-3, atol=1e-5)
    # the scan lies on the map: the wall pins x, the ground z (nothing pins y)
    assert abs(float(rb.pose[3])) < 0.05 and abs(float(rb.pose[5])) < 0.05


def test_register_gates_and_refusals():
    map_pts, scan = planar_scene(5, n_map=1024, n_scan=200)
    init = t(np.array([0, 0, 0, 0.2, 0, 0], np.float32))
    cfg = port_config.RegistrationConfig(grid_table_size=1024)
    few = np.zeros(200, bool)
    few[:30] = True                                     # not more than 30
    r = treg.register(t(scan), t(few), t(map_pts), t(np.ones(1024, bool)), init, cfg)
    assert r.iterations == 0 and torch.equal(r.pose, init)
    few_map = np.zeros(1024, bool)
    few_map[:50] = True                                 # not more than 50
    r = treg.register(t(scan), t(np.ones(200, bool)), t(map_pts), t(few_map),
                      init, cfg)
    assert r.iterations == 0 and torch.equal(r.pose, init)
    # the brute-force backend: the exact k-NN over the map cloud, as JAX's
    brute = dataclasses.replace(cfg, knn_backend="brute",
                                degeneracy_eig_thresh=10.0)
    mask = np.ones(200, bool)
    rj = jreg.register(jnp.asarray(scan), jnp.asarray(mask),
                       jnp.asarray(map_pts), jnp.ones(1024, bool),
                       jnp.asarray(n(init)),
                       jax_config.RegistrationConfig(
                           knn_backend="brute", grid_table_size=1024,
                           degeneracy_eig_thresh=10.0))
    rp = treg.register(t(scan), t(mask), t(map_pts), t(np.ones(1024, bool)),
                       init, brute)
    assert rp.iterations == int(rj.iterations) > 1
    assert int(rp.num_inliers) == int(rj.num_inliers)
    np.testing.assert_allclose(n(rp.pose), np.asarray(rj.pose), atol=1e-4)
    # the cell-sorted scan passes the same gates
    r = treg.register(t(scan), t(few), t(map_pts), t(np.ones(1024, bool)), init,
                      dataclasses.replace(cfg, sort_scan_by_cell=True))
    assert r.iterations == 0 and torch.equal(r.pose, init)


# --------------------------------------------------------------------------
# the circle mission of tests/test_loop_closure.py, step for step
# --------------------------------------------------------------------------

def circle_poses(count, radius=6.0, dt=0.4):
    ang = np.linspace(0, 2 * np.pi, count, endpoint=False)
    poses = np.stack([np.zeros(count), np.zeros(count), ang + np.pi / 2,
                      radius * np.cos(ang) - radius, radius * np.sin(ang),
                      np.zeros(count)], 1).astype(np.float32)
    return poses, np.arange(count, dtype=np.float32) * dt


def scan_input(mod, pc_mod, arr, scan, mask, stamp, guess, gvalid, rpy):
    return mod.ScanInput(
        cloud=pc_mod.Cloud(xyz=arr(scan), mask=arr(mask)),
        stamp=arr(np.float32(stamp)), init_guess=arr(guess),
        guess_valid=arr(np.bool_(gvalid)), imu_rpy=arr(rpy),
        imu_available=arr(np.bool_(True)), gps_pos=arr(np.zeros(3, np.float32)),
        gps_info=arr(np.zeros(3, np.float32)), gps_valid=arr(np.bool_(False)))


@pytest.fixture(scope="module")
def circle_run():
    """Both packages over the 22-scan circle and the closing scan, each on
    its own state; the detector runs after each of the last six scans."""
    jcfg, tcfg = loop_config(jax_config), loop_config(port_config)
    count = 22
    poses, stamps = circle_poses(count)
    world = jsynthetic.make_world(seed=0, extent=40.0, n_per_surface=40000)
    rs = np.random.RandomState(5)
    jstep, tstep = jlio.make_lio_step(jcfg), tlio.make_lio_step(tcfg)
    jdet, tdet = jloop.make_loop_detector(jcfg), tloop.make_loop_detector(tcfg)
    ja, tb = jlio.init_state(jcfg), tlio.init_state(tcfg)
    prev = [None, None]
    log = {"pose": [], "kf": [], "iters": [], "aux": [], "pend": [], "submaps": None}
    targets = list(poses) + [poses[0]]
    for i, target in enumerate(targets):
        scan, mask = jsynthetic.observe(world, target, 4096, rng=rs)
        stamp = stamps[i] if i < count else stamps[-1] + 0.4
        inps = []
        for k in range(2):
            if i == 0:
                guess, gvalid = np.zeros(6, np.float32), False
            else:
                inc = jse3.pose6_between(jnp.asarray(targets[i - 1]),
                                         jnp.asarray(target))
                guess = n(jse3.pose6_compose(jnp.asarray(prev[k]), inc))
                gvalid = True
            inps.append((guess, gvalid))
        ja, oa = jstep(ja, scan_input(jlio, jpc, jnp.asarray, scan, mask, stamp,
                                      *inps[0], target[:3]))
        tb, ob = tstep(tb, scan_input(tlio, tpc, t, scan, mask, stamp, *inps[1],
                                      target[:3]))
        prev = [n(oa.pose), n(ob.pose)]
        log["pose"].append(prev)
        log["kf"].append((bool(oa.is_keyframe), bool(ob.is_keyframe)))
        log["iters"].append((int(oa.registration_iters), ob.registration_iters))
        if count - 6 <= i < count:
            if log["submaps"] is None:
                c = int(ja.store.count) - 1
                log["submaps"] = (
                    jloop._submap_around(ja.store, jnp.int32(2), 3, 8192, 0.4),
                    tloop._submap_around(convert.from_numpy(
                        jax.tree.map(np.array, ja)).store, torch.tensor(2), 3,
                        8192, 0.4),
                    jloop._submap_around(ja.store, jnp.int32(c), 3, 8192, 0.4),
                    tloop._submap_around(convert.from_numpy(
                        jax.tree.map(np.array, ja)).store, torch.tensor(c), 3,
                        8192, 0.4))
            ja, aa = jdet(ja)
            tb, ab = tdet(tb)
            log["aux"].append((jax.tree.map(np.array, aa), ab))
            log["pend"].append((jax.tree.map(np.array, (ja.pend_mask, ja.pend_i,
                                                        ja.pend_j, ja.last_loop_kf)),
                                (tb.pend_mask, tb.pend_i, tb.pend_j,
                                 tb.last_loop_kf)))
    before = (jax.tree.map(np.array, ja), tb)
    assert bool(ja.needs_full_solve) and bool(tb.needs_full_solve)
    ja = jlio.make_full_correction(jcfg)(ja)
    tb = tlio.make_full_correction(tcfg, device="cpu")(tb)
    return jcfg, tcfg, log, before, (jax.tree.map(np.array, ja), tb)


def test_submap_around_matches(circle_run):
    """The same store (the JAX state carried over) through both: the
    downsampled submap's points and mask, near the start of the store (the
    window clipped at 0) and at its end (keyframes past `count` masked)."""
    sub = circle_run[2]["submaps"]
    for a, b in ((sub[0], sub[1]), (sub[2], sub[3])):
        assert b.xyz.shape == (8192, 3) and b.mask.dtype == torch.bool
        np.testing.assert_array_equal(n(b.mask), n(a.mask))
        assert 1000 < int(b.mask.sum()) <= 8192    # 7 x 2048 points fill it
        m = n(a.mask)
        np.testing.assert_allclose(n(b.xyz)[m], n(a.xyz)[m], atol=1e-5)


def test_circle_steps_match(circle_run):
    log = circle_run[2]
    assert [k[1] for k in log["kf"]] == [k[0] for k in log["kf"]]
    assert [k[1] for k in log["iters"]] == [k[0] for k in log["iters"]]
    dev = np.abs(np.stack([p[1] for p in log["pose"]])
                 - np.stack([p[0] for p in log["pose"]]))
    assert dev.max() < 2e-3, dev.max(axis=0)       # measured 2.4e-4


def test_circle_detector_cycles_match(circle_run):
    log = circle_run[2]
    assert len(log["aux"]) == 6
    accepted = 0
    for (aa, ab), (pa, pb) in zip(log["aux"], log["pend"]):
        np.testing.assert_array_equal(n(ab["loop_accepted"]), aa["loop_accepted"])
        np.testing.assert_array_equal(n(ab["loop_pair_i"]), aa["loop_pair_i"])
        acc = aa["loop_accepted"]
        np.testing.assert_array_equal(n(ab["loop_pair_j"])[acc],
                                      aa["loop_pair_j"][acc])
        np.testing.assert_allclose(n(ab["loop_fitness"]), aa["loop_fitness"],
                                   atol=2e-3)
        assert len(ab["loop_iters"]) == int((n(ab["loop_fitness"]) > 0).sum())
        assert all(1 <= k <= 30 for k in ab["loop_iters"])
        accepted += int(acc.sum())
        for x, y in zip(pa, pb):                   # queue and last_loop_kf
            np.testing.assert_array_equal(n(y), x)
    assert accepted >= 1


def test_circle_loop_consumed_and_corrected(circle_run):
    jcfg, tcfg, _, (ja0, tb0), (ja, tb) = circle_run
    K = tcfg.static.max_keyframes
    assert int(tb0.loop_count) == int(ja0.loop_count) >= 1
    assert not bool(tb0.pend_mask.any())
    for name in ("bt_i", "bt_j", "bt_mask", "pose_mask", "gps_mask"):
        np.testing.assert_array_equal(n(getattr(tb0.graph, name)),
                                      getattr(ja0.graph, name), err_msg=name)
    assert n(tb0.graph.bt_mask)[K - 1:].sum() >= 1
    np.testing.assert_allclose(n(tb0.graph.bt_meas), ja0.graph.bt_meas, atol=5e-3)
    np.testing.assert_allclose(n(tb0.graph.bt_info), ja0.graph.bt_info, rtol=0.1)
    count = int(tb.store.count)
    assert count == int(ja.store.count)
    assert not bool(tb.needs_full_solve)
    # measured 1.1e-3: the loop's measurement comes from a float32 GN run
    np.testing.assert_allclose(n(tb.store.poses), ja.store.poses, atol=5e-3)
    np.testing.assert_array_equal(n(tb.store.poses)[:count],
                                  n(tb.graph.poses)[:count])
    np.testing.assert_array_equal(n(tb.pose), n(tb.store.poses)[count - 1])
    moved = np.abs(n(tb.store.poses) - n(tb0.store.poses)).max()
    assert moved > 1e-4                                # the correction acted
    # the rebuilt map holds the corrected keyframes: the same buckets but for
    # the points that poses 1e-3 apart put across a cell boundary (measured:
    # 82 of 32768 buckets differ, by one point each)
    ca, cb = ja.map_grid.counts, n(tb.map_grid.counts)
    assert np.abs(cb - ca).max() <= 2 and (cb != ca).mean() < 0.01
    assert abs(int(cb.sum()) - int(ca.sum())) < 0.005 * int(ca.sum())
    assert not torch.equal(tb.map_grid.table, tb0.map_grid.table)


@pytest.mark.parametrize("solver_name", ["dense", "sparse"])
def test_full_correction_solvers_agree(circle_run, solver_name):
    """`full_solver` = dense and sparse on the post-loop state, against the
    JAX correction with the same solver and against each other."""
    jcfg, tcfg, _, (ja0, tb0), _ = circle_run
    with_solver = lambda cfg: dataclasses.replace(
        cfg, static=dataclasses.replace(cfg.static, full_solver=solver_name))
    assert tlio._use_sparse_solver(with_solver(tcfg)) == (solver_name == "sparse")
    ja = jlio.make_full_correction(with_solver(jcfg))(
        jax.tree.map(jnp.asarray, ja0))
    tb = tlio.make_full_correction(with_solver(tcfg), device="cpu")(tb0)
    count = int(tb.store.count)
    np.testing.assert_allclose(n(tb.graph.poses)[:count],
                               n(ja.graph.poses)[:count], atol=5e-3)
    other = tlio.make_full_correction(tcfg, device="cpu")(tb0)   # auto: dense
    np.testing.assert_allclose(n(tb.graph.poses)[:count],
                               n(other.graph.poses)[:count], atol=5e-3)
    # a state whose flag is down comes back as it is
    assert tlio.make_full_correction(tcfg, device="cpu")(tb) is tb


def test_use_sparse_solver_selection():
    cfg = port_config.Config()
    assert cfg.static.max_keyframes == 2048 and tlio._use_sparse_solver(cfg)
    small = dataclasses.replace(cfg, static=dataclasses.replace(
        cfg.static, max_keyframes=512))
    assert not tlio._use_sparse_solver(small)
    with pytest.raises(ValueError, match="full_solver"):
        tlio._use_sparse_solver(dataclasses.replace(
            cfg, static=dataclasses.replace(cfg.static, full_solver="qr")))


def test_inject_loop_constraint_matches(circle_run):
    _, _, _, (ja0, _), _ = circle_run
    ja, tb0 = jax.tree.map(jnp.asarray, ja0), convert.from_numpy(ja0)
    meas = np.array([0, 0, 0.1, 0.5, 0.2, 0], np.float32)
    info = np.full(6, 11.0, np.float32)
    count = int(tb0.store.count)
    for i, j in ((1, 9), (count, 3), (4, 4), (-1, 2), (0, count - 1)):
        sa, oka = jlio.inject_loop_constraint(ja, i, j, jnp.asarray(meas),
                                              jnp.asarray(info))
        sb, okb = tlio.inject_loop_constraint(tb0, i, j, t(meas), t(info))
        assert bool(okb) == bool(oka) == (0 <= i < count and i != j)
        for name in ("pend_i", "pend_j", "pend_mask", "pend_meas", "pend_info"):
            np.testing.assert_array_equal(n(getattr(sb, name)),
                                          n(getattr(sa, name)), err_msg=name)
    # a full queue refuses
    full = tb0
    for k in range(tb0.pend_mask.shape[0]):
        full, ok = tlio.inject_loop_constraint(full, 0, k + 1, t(meas), t(info))
        assert bool(ok)
    full, ok = tlio.inject_loop_constraint(full, 0, 9, t(meas), t(info))
    assert not bool(ok)
