"""tests/test_fault_injection.py on the port, case for case, each held
against the JAX package on the same inputs: IMU dropout, IMU divergence and
its reset, the GPS outage FSM, the GPS jump gate, a NaN scan, an empty scan
and a degenerate (single-plane) scene.

Each mission runs `Runner(device="cpu")` and the JAX `Runner` over the
same numpy scans and IMU windows.  The JAX test's own assertions hold on
the port; `mapping_error` after every scan, the degenerate and keyframe
flags, the FSM modes, the keyframe and eviction counts are the JAX run's,
and the poses stay within 1e-3 m and 0.01 deg of it (`assert_runs_match`).
"""

import numpy as np
import pytest

import torch_port_helpers as H
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.pipeline import gps_fusion as jgf
from lio_slam_tpu.pipeline.runner import Runner as JaxRunner
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch.io import formats
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.pipeline import gps_fusion as gf
from lio_slam_tpu_torch.pipeline.runner import Runner


def small_cfg(m, **kw):
    """The config of tests/test_fault_injection.py."""
    return m.Config(
        static=m.StaticConfig(max_raw_points=2048, max_scan_points=2048,
                              max_map_points=8192, max_keyframes=16,
                              max_keyframe_points=1024, max_loop_queue=2,
                              max_gps_queue=2, window_size=8,
                              max_imu_window=32),
        registration=m.RegistrationConfig(degeneracy_eig_thresh=10.0), **kw)


@pytest.fixture(scope="module")
def seq():
    return synthetic.make_sequence(n_scans=8, n_points=2048, seed=0)


def scan_at(seq, i, xyz_override=None):
    m = seq.scan_masks[i]
    xyz = seq.scans[i][m] if xyz_override is None else xyz_override
    n = len(xyz)
    return formats.StandardScan(
        xyz=xyz.astype(np.float32), intensity=np.zeros(n, np.float32),
        ring=np.zeros(n, np.uint16), time=np.zeros(n, np.float32),
        stamp=float(seq.stamps[i]))


def imu_between(seq, i, g=9.81, gyro_scale=1.0, acc_override=None):
    """The IMU window of tests/test_fault_injection.py: 10 samples of the
    truth increment's rates, 10 ms apart, after scan i-1's stamp."""
    inc = H.truth_increment(seq.poses[i - 1], seq.poses[i])
    T, dtau = 10, 0.01
    acc = (np.tile([0, 0, g], (T, 1)) if acc_override is None
           else np.tile(acc_override, (T, 1)))
    return {"acc": acc.astype(np.float32),
            "gyr": np.tile(inc[:3] / 0.1 * gyro_scale, (T, 1)).astype(np.float32),
            "stamps": seq.stamps[i - 1] + np.arange(1, T + 1) * dtau}


def both_runners(**kw):
    return (Runner(small_cfg(port_config, **kw), device="cpu", loop_every=100),
            JaxRunner(small_cfg(jax_config, **kw), loop_every=100))


def test_imu_dropout_mid_mission(seq):
    """Scans with no IMU window fall back to odometry-increment guesses; the
    trajectory stays finite and keeps tracking.

    Free-running, the port's poses keep within 2e-3 m and 0.05 deg of the
    JAX run's, not the 1e-3 m and 0.01 deg of the other cases: measured
    1.80e-3 m and 0.042 deg at scan 6 (3.2e-4 m at scan 7, under 7e-7 m
    before).  The front-ends part at scan 5's correction, the first after
    the two scans without IMU (velocity after the mission 3.53 against
    3.47 m/s); scan 6 starts from that prediction and ends at the 30-iteration
    cap of the GN loop, so its pose keeps the guess's difference.  With the
    JAX front-end's state carried into each scan the poses agree within
    1e-3 m and 0.01 deg (measured 7.8e-7 m)."""
    steps = [(scan_at(seq, i),
              imu_between(seq, i) if (i > 0 and i not in (3, 4)) else None)
             for i in range(8)]
    port, ref = H.run_both(*both_runners(), steps)
    for r in port.results:
        assert np.isfinite(r.pose).all()
    assert not port.runner.mapping_error
    H.assert_runs_match(port, ref, atol_m=2e-3, atol_rad=np.radians(0.05))
    H.assert_runs_match(*H.run_both(*both_runners(), steps,
                                    carry_imu_state=True))


def test_imu_divergence_triggers_mapping_error_and_reset(seq):
    """5000 m/s^2 trips failureDetection (|v| > 30): mapping_error and a
    front-end reset; the next sane window clears the flag."""
    steps = [(scan_at(seq, 0), None), (scan_at(seq, 1), imu_between(seq, 1)),
             (scan_at(seq, 2), imu_between(seq, 2,
                                           acc_override=[5000.0, 0, 9.81])),
             (scan_at(seq, 3), imu_between(seq, 3))]
    port, ref = H.run_both(*both_runners(), steps)
    assert port.mapping_error == [False, False, True, False]
    assert np.isfinite(port.results[-1].pose).all()
    assert not port.runner.mapping_error
    H.assert_runs_match(port, ref)


def fsm_walk(module, cfg):
    fsm = module.PositioningModeFSM(cfg)
    modes = []
    t = 100.0
    fsm.on_gps(t)
    modes.append(fsm.step(t, now=t))
    t_out = t + 2.5
    modes.append(fsm.step(t_out, now=t_out))
    t2 = t_out + 0.05
    fsm.on_gps(t2)
    modes.append(fsm.step(t2, now=t2))
    tt = t2
    for _ in range(100):
        tt += 0.1
        fsm.on_gps(tt)
        modes.append(fsm.step(tt, now=tt))
        if modes[-1] == module.MODE_NORMAL:
            break
    return modes, fsm.converging


def test_gps_outage_fsm_jam_and_recover():
    """Raw-GPS gaps > threshold -> JAMMED; steady fixes -> RECOVERING ->
    NORMAL (gpsDataHandler FSM, mapOptmization.cpp:616-726), step for step
    as the JAX FSM."""
    modes, converging = fsm_walk(gf, port_config.GpsConfig())
    assert modes[0] == gf.MODE_NORMAL
    assert modes[1] == gf.MODE_JAMMED
    assert modes[2] == gf.MODE_RECOVERING
    assert modes[-1] == gf.MODE_NORMAL
    # the reference quirk: RECOVERING exits before the converge timer clears
    assert converging
    assert (modes, converging) == fsm_walk(jgf, jax_config.GpsConfig())


def jump_walk(module, cfg):
    intake = module.GpsIntake(cfg)
    t = 10.0
    obs = []
    for i in range(8):
        obs.append(intake.on_fix(t + i, 39.90 + i * 1e-7, 116.30, 50.0,
                                 status=0, mode_normal=True))
    jump = intake.on_fix(t + 9, 39.90 + 0.001, 116.30, 50.0, status=0,
                         mode_normal=True)
    return obs, jump


def test_gps_jump_rejected_by_accuracy_gate():
    """A position jump bigger than the covariance gate is no 'accurate'
    observation; every observation is the JAX intake's."""
    obs, jump = jump_walk(gf, port_config.GpsConfig())
    assert jump is None or not jump.accurate
    jobs, jjump = jump_walk(jgf, jax_config.GpsConfig())
    for a, b in zip(obs + [jump], jobs + [jjump]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.accurate == b.accurate
            np.testing.assert_allclose(a.enu, b.enu, atol=1e-9)
            np.testing.assert_allclose(a.covariance, b.covariance, atol=1e-12)


def test_nan_scan_survived(seq):
    """NaN points are dropped by the format layer, not poisoning the
    pipeline (the reference exits on is_dense=false)."""
    xyz = seq.scans[1][seq.scan_masks[1]].copy()
    xyz[::7] = np.nan
    clean = formats.from_velodyne(xyz, np.zeros(len(xyz), np.float32),
                                  np.zeros(len(xyz), np.uint16),
                                  np.zeros(len(xyz), np.float32),
                                  float(seq.stamps[1]))
    assert np.isfinite(clean.xyz).all()
    steps = [(scan_at(seq, 0), None), (clean, imu_between(seq, 1))]
    port, ref = H.run_both(*both_runners(), steps)
    assert np.isfinite(port.results[-1].pose).all()
    H.assert_runs_match(port, ref)


def test_empty_scan_survived(seq):
    empty = formats.StandardScan(
        xyz=np.zeros((0, 3), np.float32), intensity=np.zeros(0, np.float32),
        ring=np.zeros(0, np.uint16), time=np.zeros(0, np.float32),
        stamp=float(seq.stamps[1]))
    steps = [(scan_at(seq, 0), None), (empty, imu_between(seq, 1)),
             (scan_at(seq, 2), imu_between(seq, 2))]
    port, ref = H.run_both(*both_runners(), steps)
    for r in port.results:
        assert np.isfinite(r.pose).all()
    H.assert_runs_match(port, ref)


def plane_scans(n=1500):
    rs = np.random.RandomState(0)
    out = []
    for i in range(2):
        xyz = np.stack([rs.uniform(-10, 10, n), rs.uniform(-10, 10, n),
                        rs.normal(0, 0.02, n) - 1.5], 1).astype(np.float32)
        out.append((formats.StandardScan(
            xyz=xyz, intensity=np.zeros(n, np.float32),
            ring=np.zeros(n, np.uint16), time=np.zeros(n, np.float32),
            stamp=0.1 * i), None))
    return out


def test_degenerate_scene_flags_and_survives():
    """A single plane constrains 3 DoF: the degeneracy gate fires (eigen
    masking) and the pose stays finite (mapOptmization.cpp:1786-1814)."""
    port, ref = H.run_both(*both_runners(), plane_scans())
    r = port.results[-1]
    assert r.degenerate
    assert np.isfinite(r.pose).all()
    H.assert_runs_match(port, ref)
