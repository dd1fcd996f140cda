"""The port's slice as a whole: `Runner(device="cpu")` against the JAX
`Runner` on the small mission of tests/test_runner.py (loop closure off),
one mapping step from a state carried over from the JAX package, and a small
mission with loop closure and GPS on (factor counts, detector decisions and
the scans of the full corrections identical, poses within 2e-3: a loop's
measurement is the result of a float32 GN run; measured 2e-4).

Tolerance: keyframe decisions and GN iteration counts identical, per-scan
poses within 1e-4 (m and rad); measured 3.3e-6 at seed 0 and 1.1e-6 at
seed 1.  What is left is the JAX front-end's float32 covariance update: the
first update after initialization meets the 1e8 velocity prior and cancels
about 8 digits, which the port avoids by running that 15x15 algebra in
float64 (pipeline/imu_frontend.py).  On seed 2 that gap reaches 1.9e-4 m
and one GN iteration; with the JAX front-end state carried into the port
before every scan it closes to 6.4e-7 m, so the mapping path itself agrees
to float32 rounding.
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, small_config, t
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.pipeline import lio as jlio
from lio_slam_tpu.pipeline.runner import Runner as JaxRunner
from lio_slam_tpu.utils import pointcloud as jpc
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch import convert
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.ops import _build
from lio_slam_tpu_torch.pipeline import lio as tlio
from lio_slam_tpu_torch.pipeline import synthetic_mission as sm
from lio_slam_tpu_torch.pipeline.runner import Runner
from lio_slam_tpu_torch.utils import pointcloud as tpc
from lio_slam_tpu_torch.utils import se3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SCANS = 10


def jax_runner_counting_iters():
    """The JAX Runner, with the GN iteration count of each scan recorded
    (its ScanResult does not carry it)."""
    jr = JaxRunner(small_config(jax_config), loop_every=1000)
    iters, step = [], jr.step

    def counting_step(state, inp):
        state, out = step(state, inp)
        iters.append(int(out.registration_iters))
        return state, out

    jr.step = counting_step
    return jr, iters


def run_both(seed, carry_imu_state=False):
    """Both runners over one mission; with `carry_imu_state` the port starts
    every scan from the JAX front-end's state."""
    seq = synthetic.make_sequence(n_scans=N_SCANS, n_points=2048, seed=seed)
    scans, imus = sm.synthetic_inputs(seq, small_config(port_config))
    jr, iters = jax_runner_counting_iters()
    tr = Runner(small_config(port_config), device="cpu")
    ja, tb = [], []
    before = _build.LAUNCHES.copy(), _build.CAPTURED.copy()
    for i in range(N_SCANS):
        if carry_imu_state:
            tr.imu_state = convert.from_numpy(jax.tree.map(np.array, jr.imu_state))
        ja.append(jr.process_scan(scans[i], imu=imus[i]))
        tb.append(tr.process_scan(scans[i], imu=imus[i]))
    assert (_build.LAUNCHES, _build.CAPTURED) == before  # CPU: plain
    return seq, (jr, ja, iters), (tr, tb)


@pytest.fixture(scope="module", params=[0, 1], ids=lambda s: f"seed{s}")
def missions(request):
    return run_both(request.param)


def test_keyframe_decisions_identical(missions):
    _, (jr, ja, _), (tr, tb) = missions
    assert [r.is_keyframe for r in tb] == [r.is_keyframe for r in ja]
    assert sum(r.is_keyframe for r in tb) >= 2
    assert int(tr.state.store.count) == int(jr.state.store.count)


def test_poses_within_tolerance(missions):
    _, (jr, ja, _), (tr, tb) = missions
    dev = np.abs(np.stack([r.pose for r in tb]) - np.stack([r.pose for r in ja]))
    assert dev.max() < 1e-4, dev.max(axis=0)
    np.testing.assert_allclose(np.stack(tr.trajectory), np.stack(jr.trajectory),
                               atol=1e-4)


def test_registration_iters_identical(missions):
    _, (_, _, iters), (_, tb) = missions
    assert [r.registration_iters for r in tb] == iters
    assert sum(iters) > 0


def test_carried_imu_state_closes_the_gap():
    _, (jr, ja, iters), (tr, tb) = run_both(2, carry_imu_state=True)
    assert [r.is_keyframe for r in tb] == [r.is_keyframe for r in ja]
    assert [r.registration_iters for r in tb] == iters
    dev = np.abs(np.stack([r.pose for r in tb]) - np.stack([r.pose for r in ja]))
    assert dev.max() < 1e-5, dev.max(axis=0)


def test_scan_results(missions):
    seq, (jr, ja, _), (tr, tb) = missions
    for a, b in zip(ja, tb):
        assert b.degenerate == a.degenerate
        assert abs(b.num_inliers - a.num_inliers) <= max(5, a.num_inliers // 100)
        assert b.positioning_mode == a.positioning_mode == 0
        assert (b.imu_rate_poses is None) == (a.imu_rate_poses is None)
        if b.imu_rate_poses is not None:
            assert b.imu_rate_poses.shape == np.asarray(a.imu_rate_poses).shape
            assert b.fused_rate_poses.shape == np.asarray(a.fused_rate_poses).shape
    assert tb[0].registration_iters == 0 and tb[1].registration_iters > 0
    assert not tr.mapping_error
    rel = sm.relative_truth(seq)
    assert synthetic.ate_rmse(np.stack(tr.trajectory), rel) < 0.05


def step_input(mod, pc_mod, seq, i, arr):
    return mod.ScanInput(
        cloud=pc_mod.Cloud(xyz=arr(seq.scans[i]), mask=arr(seq.scan_masks[i])),
        stamp=arr(np.float32(seq.stamps[i])), init_guess=arr(np.zeros(6, np.float32)),
        guess_valid=arr(np.bool_(False)), imu_rpy=arr(np.zeros(3, np.float32)),
        imu_available=arr(np.bool_(False)), gps_pos=arr(np.zeros(3, np.float32)),
        gps_info=arr(np.zeros(3, np.float32)), gps_valid=arr(np.bool_(False)))


def test_step_from_carried_state():
    """Three JAX steps, convert.from_numpy, then one keyframe step in both."""
    seq = synthetic.make_sequence(n_scans=4, n_points=2048, seed=2, speed=4.0)
    jcfg, tcfg = small_config(jax_config), small_config(port_config)
    jstep, tstep = jlio.make_lio_step(jcfg), tlio.make_lio_step(tcfg)
    state = jlio.init_state(jcfg)
    jin = lambda i: step_input(jlio, jpc, seq, i, jnp.asarray)
    for i in range(3):
        state, _ = jstep(state, jin(i))
    carried = jax.tree.map(np.array, state)
    ja, oa = jstep(jax.tree.map(jnp.asarray, carried), jin(3))
    tb, ob = tstep(convert.from_numpy(carried), step_input(tlio, tpc, seq, 3, t))
    assert ob.is_keyframe and bool(oa.is_keyframe)
    assert ob.registration_iters == int(oa.registration_iters) > 0
    np.testing.assert_allclose(n(ob.pose), n(oa.pose), atol=1e-4)
    np.testing.assert_array_equal(n(tb.map_grid.counts), n(ja.map_grid.counts))
    np.testing.assert_allclose(n(tb.map_grid.table), n(ja.map_grid.table), atol=1e-3)
    np.testing.assert_allclose(n(tb.store.poses), n(ja.store.poses), atol=1e-4)
    assert int(tb.store.count) == int(ja.store.count) == 2


def test_unported_features_refused(tmp_path):
    """Nothing is refused any more: bag recording, the keyframe archive,
    batched fetches, checkpoints, the mission log, the LOAM corner path, the
    rebuild-mode local map and the brute-force k-NN are ported, so their
    configs build as they are; the sharded mesh is ported too
    (tests/test_torch_sharded_mission.py), and a `mesh` that is not a
    DeviceMesh raises a TypeError naming it."""
    cfg = small_config(port_config)
    reg = port_config.RegistrationConfig
    for kw in (dict(use_corner_features=True),
               dict(use_corner_features=True, local_map_mode="rebuild"),
               dict(local_map_mode="rebuild"), dict(knn_backend="brute")):
        built = Runner(dataclasses.replace(cfg, registration=reg(**kw)),
                       device="cpu")
        assert built.cfg.registration == reg(**kw)
        assert built.state.store.corner_clouds.shape[1] == (
            cfg.static.max_corner_points if kw.get("use_corner_features") else 1)
    recording = Runner(cfg, device="cpu", record_bag=str(tmp_path / "out.bag"))
    assert recording._bag is not None
    recording.close()
    assert os.path.exists(tmp_path / "out.bag") and recording._bag is None
    with pytest.raises(TypeError, match="mesh"):
        Runner(cfg, device="cpu", mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        Runner(cfg, device="cpu", record_bag=str(tmp_path / "b.bag"),
               mesh=object())
    # the default loop configuration has the keyframe archive on
    archived = Runner(dataclasses.replace(cfg, loop=port_config.LoopClosureConfig()),
                      device="cpu", fetch_every=4, auto_checkpoint="ckpt.npz",
                      checkpoint_every=7)
    assert archived.archive_enabled and archived.fetch_every == 4
    assert archived._checkpoint_every == 7 and len(archived._archive) == 0
    # loop closure without the archive, and GPS, are ported
    on = dataclasses.replace(
        cfg, loop=port_config.LoopClosureConfig(archive_enabled=False),
        gps=port_config.GpsConfig(use_gps=True))
    runner = Runner(on, device="cpu", loop_every=7)
    assert runner.loop_every == 7 and runner.last_loop_aux is None
    assert not runner.archive_enabled and runner._archive is None
    # a fix on a mission without GPS is taken and ignored, as in the JAX Runner
    seq = synthetic.make_sequence(n_scans=1, n_points=256, seed=0)
    scans, _ = sm.synthetic_inputs(seq, cfg)
    r = Runner(cfg, device="cpu").process_scan(scans[0], gps_fix=(45.0, 7.0, 200.0))
    assert r.positioning_mode == 0


def test_default_config_builds_unmodified():
    """`Runner(get_config("default"))` needs no change to the preset: the
    archive is on, as in the JAX Runner."""
    runner = Runner(port_config.get_config("default"), device="cpu")
    jr_cfg = jax_config.get_config("default")
    assert runner.archive_enabled == (jr_cfg.loop.enabled and jr_cfg.loop.archive_enabled)
    assert runner.archive_enabled and runner._kf_snapshot is not None
    assert runner.health()["archived_keyframes"] == 0


def loop_gps_config(m):
    """The small mission config with loop closure (archive off) and GPS on,
    gates lowered so that a 3 s mission meets them."""
    return dataclasses.replace(
        small_config(m),
        loop=m.LoopClosureConfig(enabled=True, archive_enabled=False,
                                 time_diff=0.8, sc_exclude_recent=3),
        gps=m.GpsConfig(use_gps=True, pose_cov_threshold=-1.0,
                        gps_distance_frequency=2.0, min_travel_before_gps=1.0))


def run_loop_gps_missions():
    """Both runners over 22 scans at 3 m/s with a GPS fix a scan and the
    loop detector every 6 scans.  The radius search finds the nearest
    keyframe older than 0.8 s, a few metres back, and verification against
    the submap around it accepts it: a loop factor without a revisit.  (The
    mission ends after the loop's correction: a later verification starts
    at its optimum, where the GN stopping rule is decided by float32 noise,
    and two states 1e-3 apart may disagree on `converged`, in either
    package.)"""
    n_scans, every = 22, 6
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=0, speed=3.0)
    tcfg = loop_gps_config(port_config)
    scans, imus = sm.synthetic_inputs(seq, tcfg)
    fixes = synthetic.gps_fixes_from_truth(
        sm.relative_truth(seq)[:, 3:].astype(np.float64), seq.stamps, seed=4)
    jr = JaxRunner(loop_gps_config(jax_config), loop_every=every)
    tr = Runner(tcfg, device="cpu", loop_every=every)
    corrected, full_correct = [], jr.full_correct

    def watching_correct(state):
        if bool(state.needs_full_solve):
            corrected.append(jr.scan_count)
        return full_correct(state)

    jr.full_correct = watching_correct
    cycles, detector = [], jr.detector

    def watching_detector(state):
        state, aux = detector(state)
        cycles.append(jax.tree.map(np.array, aux))
        return state, aux

    jr.detector = watching_detector
    ja, tb, tcycles, counts = [], [], [], []
    for i in range(n_scans):
        ja.append(jr.process_scan(scans[i], imu=imus[i], gps_fixes=fixes[i]))
        tb.append(tr.process_scan(scans[i], imu=imus[i], gps_fixes=fixes[i]))
        if (i + 1) % every == 0:
            tcycles.append(tr.last_loop_aux)
        counts.append(((int(jr.state.loop_count), int(jr.state.gps_count)),
                       (int(tr.state.loop_count), int(tr.state.gps_count))))
    return (jr, ja, corrected, cycles), (tr, tb, tcycles), counts


@pytest.fixture(scope="module")
def loop_gps_missions():
    return run_loop_gps_missions()


def test_loop_gps_mission_factors_and_corrections_match(loop_gps_missions):
    (jr, ja, corrected, _), (tr, tb, _), counts = loop_gps_missions
    assert [c[1] for c in counts] == [c[0] for c in counts]
    assert counts[-1][1][0] >= 1 and counts[-1][1][1] >= 2   # loops, GPS factors
    assert tr.full_correction_scans == corrected
    assert len(corrected) >= 3
    assert not bool(tr.state.needs_full_solve)
    assert [r.is_keyframe for r in tb] == [bool(r.is_keyframe) for r in ja]
    K = tr.cfg.static.max_keyframes
    for name in ("bt_i", "bt_j", "bt_mask", "gps_i", "gps_mask", "pose_mask"):
        np.testing.assert_array_equal(n(getattr(tr.state.graph, name)),
                                      n(getattr(jr.state.graph, name)), err_msg=name)
    assert n(tr.state.graph.bt_mask)[K - 1:].sum() == counts[-1][1][0]


def test_loop_gps_mission_detector_cycles_match(loop_gps_missions):
    (_, _, _, cycles), (tr, _, tcycles), _ = loop_gps_missions
    assert len(tcycles) == len(cycles) == 3
    for a, b in zip(cycles, tcycles):
        np.testing.assert_array_equal(b["loop_accepted"], a["loop_accepted"])
        np.testing.assert_array_equal(b["loop_pair_i"], a["loop_pair_i"])
        acc = a["loop_accepted"]
        np.testing.assert_array_equal(b["loop_pair_j"][acc], a["loop_pair_j"][acc])
        np.testing.assert_allclose(b["loop_fitness"], a["loop_fitness"], atol=2e-3)
        assert isinstance(b["loop_accepted"], np.ndarray)
        assert len(b["loop_iters"]) == int((b["loop_fitness"] > 0).sum())
    assert any(a["loop_accepted"].any() for a in cycles)
    assert tr.timer.stats["loop_closure"].count == 3


def test_loop_gps_mission_poses_within_tolerance(loop_gps_missions):
    (jr, ja, _, _), (tr, tb, _), _ = loop_gps_missions
    dev = np.abs(np.stack([r.pose for r in tb]) - np.stack([r.pose for r in ja]))
    assert dev.max() < 2e-3, dev.max(axis=0)
    count = int(tr.state.store.count)
    assert count == int(jr.state.store.count)
    np.testing.assert_allclose(n(tr.state.store.poses)[:count],
                               n(jr.state.store.poses)[:count], atol=2e-3)
    assert all(r.positioning_mode == a.positioning_mode == 0
               for r, a in zip(tb, ja))
    assert not tr.mapping_error


def test_fusion_outputs_and_raw_gps_match(loop_gps_missions):
    """The geodetic outputs and the positioning-mode machine of both runners
    after the same mission and the same raw-GPS stream."""
    (jr, _, _, _), (tr, _, _), _ = loop_gps_missions
    stamp = 1000.0
    fa, fb = jr.fusion_output(stamp), tr.fusion_output(stamp)
    assert fb.stamp == fa.stamp and fb.mode == fa.mode
    for name in ("latitude", "longitude"):
        assert abs(getattr(fb, name) - getattr(fa, name)) < 1e-7    # ~1 cm
    assert abs(fb.altitude - fa.altitude) < 2e-3
    assert abs(fb.heading - fa.heading) < 0.1
    np.testing.assert_array_equal(tr.gps_intake.datum, jr.gps_intake.datum)
    # the raw stream runs on while the corrected one has stopped: jammed
    modes = []
    for k in range(40):
        s = 2.2 + 0.1 * k
        ma = jr.on_raw_gps(s, 48.0, 11.0, 500.0, heading=90.0)
        mb = tr.on_raw_gps(s, 48.0, 11.0, 500.0, heading=90.0)
        assert mb == ma
        modes.append(mb)
    assert modes[0] == 0 and modes[-1] == 1
    (oa, sa), (ob, sb) = jr.sensor_fusion_output(stamp), tr.sensor_fusion_output(stamp)
    assert sb == sa and ob.mode == oa.mode
    assert abs(ob.latitude - oa.latitude) < 1e-7


def test_state_with_loop_and_gps_factors_round_trips(loop_gps_missions):
    """A JAX state that holds loop and GPS factors goes through `convert`
    unchanged (values and dtypes), and the full correction of both packages
    run from that one state agrees within 2e-3 (float32 solves of a graph
    whose odometry information is 1e6)."""
    (jr, _, _, _), _, _ = loop_gps_missions
    st = jax.tree.map(np.array, jr.state)
    K = st.graph.poses.shape[0]
    assert st.graph.bt_mask[K - 1:].any() and st.graph.gps_mask.any()
    back = convert.to_numpy(convert.from_numpy(st))
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    armed = st._replace(needs_full_solve=np.array(True))
    ja = jlio.make_full_correction(jr.cfg)(jax.tree.map(jnp.asarray, armed))
    tb = tlio.make_full_correction(loop_gps_config(port_config), device="cpu")(
        convert.from_numpy(armed))
    assert not bool(tb.needs_full_solve) and not bool(ja.needs_full_solve)
    np.testing.assert_allclose(n(tb.graph.poses), n(ja.graph.poses), atol=2e-3)
    # the rebuilt maps hold the same points up to those on a cell's border
    filled = (int(n(tb.map_grid.counts).sum()), int(n(ja.map_grid.counts).sum()))
    assert filled[0] > 0 and abs(filled[0] - filled[1]) <= 0.01 * filled[1]


def test_runner_inject_loop_constraint(loop_gps_missions):
    (_, _, _, _), (tr, _, _), _ = loop_gps_missions
    before = int(tr.state.pend_mask.sum())
    count = int(tr.state.store.count)
    assert not tr.inject_loop_constraint(0, count + 3, np.zeros(6, np.float32))
    assert tr.inject_loop_constraint(0, count - 1, np.zeros(6, np.float32))
    assert int(tr.state.pend_mask.sum()) == before + 1
    slot = int(np.argmax(n(tr.state.pend_mask)))
    np.testing.assert_allclose(n(tr.state.pend_info)[slot], 1.0 / 0.3 ** 2)
    assert tr._full_correct_armed


@pytest.fixture(scope="module")
def short():
    """The 8-scan mission of tests/test_runner.py: scans and IMU windows."""
    seq = synthetic.make_sequence(n_scans=8, n_points=2048, seed=0)
    scans, imus = sm.synthetic_inputs(seq, small_config(port_config))
    return seq, scans, imus


def test_fetch_every_4_gives_the_trajectory_of_fetch_every_1(short):
    """Batched fetches change when results are read, not what they are:
    the same trajectory, the same results in the same order, each handed
    out once (the JAX Runner's `fetch_every`)."""
    _, scans, imus = short
    one = Runner(small_config(port_config), device="cpu")
    four = Runner(small_config(port_config), device="cpu", fetch_every=4)
    ra, rb = [], []
    for i in range(len(scans)):
        ra.append(one.process_scan(scans[i], imu=imus[i]))
        rb.append(four.process_scan(scans[i], imu=imus[i]))
        assert len(four._pending) <= 4
    # the batch boundary keeps its newest scan queued: results at scans 3, 6
    assert [r is not None for r in rb] == [False] * 3 + [True] + [False] * 2 \
        + [True, False]
    assert four.drain().pose is four.trajectory[-1]
    assert four.drain() is None
    np.testing.assert_array_equal(np.stack(four.trajectory), np.stack(one.trajectory))
    np.testing.assert_array_equal(rb[3].pose, ra[2].pose)
    for a, b in ((ra[2], rb[3]), (ra[5], rb[6])):
        assert (b.is_keyframe, b.registration_iters, b.num_inliers, b.degenerate) \
            == (a.is_keyframe, a.registration_iters, a.num_inliers, a.degenerate)
        np.testing.assert_array_equal(b.fused_rate_poses, a.fused_rate_poses)
    assert four.timer.stats["host_fetch"].count == 3     # scans 3, 6, the tail


def test_health_drain_buffers_result(short):
    """A monitor polling health() mid-batch must not swallow the batch's
    result: the next process_scan hands it back."""
    _, scans, _ = short
    runner = Runner(small_config(port_config), device="cpu", fetch_every=4)
    got = []
    for i in range(8):
        r = runner.process_scan(scans[i])
        if r is not None:
            got.append(r)
        if i == 1:                       # a mid-batch poll drains early
            h = runner.health()
            assert "loop_memory_exhausted" in h and "archived_keyframes" not in h
            assert len(runner.trajectory) == 2 and runner._buffered_result is not None
        if i == 2:
            assert r is not None and r.pose is runner.trajectory[1]
    runner.drain()
    assert len(runner.trajectory) == 8
    assert len(got) >= 2
    assert runner.health()["scan_rate_hz"] == pytest.approx(10.0)


def test_products_and_checkpoint(tmp_path, short):
    """The Runner's map products and a checkpoint round trip (the JAX
    Runner test of the same name)."""
    _, scans, _ = short
    cfg = small_config(port_config)
    runner = Runner(cfg, device="cpu")
    for i in range(5):
        runner.process_scan(scans[i])
    pm = runner.local_planning_map()
    assert int(pm.count()) > 50
    hm = runner.height_map()
    assert int(torch.isfinite(hm.elevation).sum()) > 20
    res = runner.save_map(str(tmp_path / "maps"), resolution=0.4)
    assert res.success and res.num_points > 50
    runner.save_checkpoint(str(tmp_path / "c.npz"))
    r2 = Runner(cfg, device="cpu")
    meta = r2.load_checkpoint(str(tmp_path / "c.npz"))
    assert meta["scan_count"] == 5 and r2.scan_count == 5
    assert len(r2.trajectory) == int(r2.state.store.count)
    out = r2.process_scan(scans[5])
    assert np.isfinite(out.pose).all()
    # the JAX Runner reads the port's checkpoint
    jr = JaxRunner(small_config(jax_config), loop_every=100)
    assert jr.load_checkpoint(str(tmp_path / "c.npz"))["scan_count"] == 5
    np.testing.assert_array_equal(np.asarray(jr.state.store.poses),
                                  n(runner.state.store.poses))


def test_auto_checkpoint_crash_resume(tmp_path, short):
    """Respawn parity: a mission with auto-checkpoints every 3 scans dies
    at scan 5; `Runner.resume` restores scan 3's checkpoint and the resumed
    scans 3-7 give the uninterrupted run's poses (the same bits)."""
    _, scans, imus = short
    cfg = small_config(port_config)
    ckpt = str(tmp_path / "auto.npz")
    ref = Runner(cfg, device="cpu")
    ref_out = [ref.process_scan(scans[i], imu=imus[i]) for i in range(8)]
    r1 = Runner(cfg, device="cpu", auto_checkpoint=ckpt, checkpoint_every=3)
    for i in range(5):
        r1.process_scan(scans[i], imu=imus[i])
    del r1                               # a crash: no close(), no last save
    r2 = Runner.resume(ckpt, cfg, device="cpu")
    assert r2.scan_count == 3 and r2._imu_ready
    out = [r2.process_scan(scans[i], imu=imus[i]) for i in range(3, 8)]
    for a, b in zip(ref_out[3:], out):
        np.testing.assert_array_equal(b.pose, a.pose)
    assert not r2.mapping_error


def test_resume_restores_staleness_gate(tmp_path, short, monkeypatch):
    """A resume across real downtime treats the first correction after it
    as stale (re-anchor, not a correction across the gap)."""
    from lio_slam_tpu_torch.pipeline import imu_frontend

    _, scans, imus = short
    cfg = small_config(port_config)
    path = str(tmp_path / "ck.npz")
    runner = Runner(cfg, device="cpu")
    for i in range(4):
        runner.process_scan(scans[i], imu=imus[i])
    runner.save_checkpoint(path)
    assert runner._last_correct_t is not None
    r2 = Runner.resume(path, cfg, device="cpu")
    assert r2._last_correct_t == pytest.approx(runner._last_correct_t)
    reanchored = []
    real = imu_frontend.reinitialize
    monkeypatch.setattr(imu_frontend, "reinitialize",
                        lambda *a: reanchored.append(1) or real(*a))
    gap = cfg.imu.max_correction_age + 5.0
    late = dataclasses.replace(scans[5], stamp=float(scans[5].stamp) + gap)
    imu = {**imus[5], "stamps": np.asarray(imus[5]["stamps"]) + gap}
    out = r2.process_scan(late, imu=imu)
    assert reanchored == [1]
    assert out is not None and np.isfinite(out.pose).all()
    assert not r2.mapping_error


def test_mission_log_records(tmp_path, short):
    """One record a step with the JAX Runner's keys, then loop events with
    global ids (an injected constraint here); the JAX log parser reads it."""
    _, scans, imus = short
    cfg = dataclasses.replace(small_config(port_config),
                              keyframe=port_config.KeyframeConfig(dist_threshold=0.15))
    log_path, jlog_path = str(tmp_path / "mission.jsonl"), str(tmp_path / "jax.jsonl")
    runner = Runner(cfg, device="cpu", mission_log=log_path, fetch_every=2)
    jr = JaxRunner(dataclasses.replace(small_config(jax_config),
                                       keyframe=jax_config.KeyframeConfig(
                                           dist_threshold=0.15)),
                   loop_every=100, mission_log=jlog_path)
    for i in range(4):
        runner.process_scan(scans[i], imu=imus[i])
        jr.process_scan(scans[i], imu=imus[i])
    n_kf = int(runner.state.store.count)
    assert n_kf >= 2 and n_kf == int(jr.state.store.count)
    meas = se3.pose6_between(runner.state.store.poses[n_kf - 1],
                             runner.state.store.poses[0]).numpy()
    assert runner.inject_loop_constraint(n_kf - 1, 0, meas)
    assert jr.inject_loop_constraint(n_kf - 1, 0, meas)
    runner.close()
    jr.close()
    recs = [json.loads(line) for line in open(log_path)]
    jrecs = [json.loads(line) for line in open(jlog_path)]
    steps = [r for r in recs if "event" not in r]
    jsteps = [r for r in jrecs if "event" not in r]
    assert len(steps) == len(jsteps) == 4
    for a, b in zip(jsteps, steps):
        assert set(b) == set(a)
        assert set(b["stage_ms"]) >= {"mapping_step", "deskew"}
        for k in ("keyframe", "keyframes", "loops", "gps_factors", "evictions",
                  "mode", "degenerate", "mapping_error"):
            assert b[k] == a[k], k
        np.testing.assert_allclose(b["pose"], a["pose"], atol=1e-4)
    assert steps[-1]["keyframes"] >= 1 and steps[-1]["stage_ms"]["mapping_step"] > 0
    events = [r for r in recs if "event" in r]
    assert events == [r for r in jrecs if "event" in r]
    assert events[0]["source"] == "injected" and events[0]["i"] == n_kf - 1


def test_close_autosaves_when_save_pcd(tmp_path, short):
    """savePCD parity: close() (here through the context manager) exports
    the global map."""
    _, scans, _ = short
    cfg = dataclasses.replace(small_config(port_config),
                              output=port_config.OutputConfig(
                                  save_pcd=True, save_directory=str(tmp_path / "auto")))
    with Runner(cfg, device="cpu") as runner:
        for i in range(3):
            runner.process_scan(scans[i])
    assert os.path.exists(str(tmp_path / "auto" / "GlobalMap.pcd"))
    assert runner._mission_log is None


def test_cli_mission_log_checkpoint_and_map(tmp_path):
    """The CLI's new flags on the CPU: a mission log, an auto-checkpoint,
    a resumed run from it, a saved map and the timing report."""
    log, ck, maps = (str(tmp_path / x) for x in ("m.jsonl", "ck.npz", "maps"))
    base = ("--synthetic", "--scans", "3", "--points", "512", "--device", "cpu",
            "--preset", "default")
    out = run_cli(*base, "--mission-log", log, "--auto-checkpoint", ck,
                  "--checkpoint-every", "2", "--save-map", maps,
                  "--report-timing")
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.splitlines()[-1])
    assert summary["scans"] == 3 and len(summary["saved"]) == 4
    assert len([line for line in open(log)]) == 3
    assert os.path.exists(ck) and os.path.exists(ck + ".archive.npz")
    assert "mapping_step" in out.stderr and "health:" in out.stderr
    again = run_cli(*base, "--resume-from", ck)
    assert again.returncode == 0, again.stderr
    # the checkpoint written at close covers every scan; the throttle
    # (mappingProcessInterval 0 s) lets the scan at its last stamp through
    assert json.loads(again.stdout.splitlines()[-1])["processed"] == 1


def test_stage_timer_and_rate_monitor_match_jax():
    """`utils/profiling`: the same statistics as the JAX package's on the
    same recorded durations and stamps."""
    from lio_slam_tpu.utils import profiling as jprof
    from lio_slam_tpu_torch.utils import profiling as tprof

    ta, tb = jprof.StageTimer(), tprof.StageTimer()
    for name, dt in (("a", 0.01), ("b", 0.5), ("a", 0.03), ("a", 0.02)):
        ta.record(name, dt)
        tb.record(name, dt)
    with tb.stage("c"):
        pass
    for k in ("a", "b"):
        assert dataclasses.asdict(tb.stats[k]) == dataclasses.asdict(ta.stats[k])
    assert {k: v for k, v in tb.as_dict().items() if k != "c"} == ta.as_dict()
    assert tb.last()["a"] == 0.02 and tb.stats["c"].count == 1
    assert tb.report().splitlines()[:2] == ta.report().splitlines()
    ra, rb = jprof.RateMonitor(expected_hz=10.0), tprof.RateMonitor(expected_hz=10.0)
    for k in range(60):
        stamp = 0.1 * k + (0.05 if k > 40 else 0.0)
        ra.tick(stamp)
        rb.tick(stamp)
        assert (rb.hz, rb.healthy) == (ra.hz, ra.healthy)
    assert len(rb._stamps) == rb.window and rb.healthy


def run_cli(*args):
    return subprocess.run([sys.executable, "-m", "lio_slam_tpu_torch.pipeline.runner",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))


def test_cli_help_says_loop_closure_is_off():
    """The CLI runs the preset as it is (the keyframe archive no longer
    switched off) and offers every flag of the JAX CLI, bag replay and
    recording included; without an input it asks for one."""
    out = run_cli("--help")
    assert out.returncode == 0, out.stderr
    text = " ".join(out.stdout.split())
    assert "keyframe archive included" in text
    assert "not ported" not in text
    for flag in ("--loop-every", "--mission-log", "--auto-checkpoint",
                 "--checkpoint-every", "--resume-from", "--save-map",
                 "--report-timing", "--bag", "--lidar-topic", "--imu-topic",
                 "--gps-topic", "--sensor", "--record-bag"):
        assert flag in out.stdout, flag
    refused = run_cli("--scans", "1", "--device", "cpu")
    assert refused.returncode != 0
    assert "pass --synthetic or --bag" in refused.stderr


def test_runner_defaults_to_the_card_and_never_falls_back():
    """Without a CUDA device the default raises and names the argument to
    pass; it does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default runs on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Runner(small_config(port_config))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Runner(small_config(port_config), device="cuda:0")
    assert Runner(small_config(port_config), device="cpu").device.type == "cpu"


def test_cli_device_defaults_to_cuda():
    assert inspect.signature(Runner.__init__).parameters["device"].default == "cuda"
    out = run_cli("--synthetic", "--scans", "1", "--points", "256")
    if torch.cuda.is_available():
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout.splitlines()[-1])["device"].startswith("cuda")
    else:
        assert out.returncode != 0
        assert 'device="cpu"' in out.stderr
