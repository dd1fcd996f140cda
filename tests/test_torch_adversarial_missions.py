"""tests/test_adversarial_missions.py on the port, case for case, each held
against the JAX package on the same inputs: the degenerate corridor (its
recorded bag read back), the degenerate correction-noise inflation, an
IMU gyro-bias ramp, aggressive rotation, and a GPS jam and recovery
through bag replay.

Each mission runs `Runner(device="cpu")` and the JAX `Runner` over the
same numpy scans and IMU windows (the jam bag is written once by the port
and replayed by both, the JAX feed with the port's repaired IMU window,
`torch_port_helpers.repaired_jax_feed`).  The JAX test's own assertions
hold on the port; the degenerate and keyframe flags, `mapping_error`, the
FSM modes and the keyframe counts are the JAX run's.  The poses stay
within 1e-3 m and 0.01 deg of it on the corridor; where a mission starts
its IMU front-end from initialization inside the scans compared (the bias
ramp, the aggressive rotation, the jam replay, the noise-inflation case)
the two front-ends part at the first correction after it, where the JAX
front-end's float32 Joseph update cancels about 8 digits and the port's
float64 one does not (tests/test_torch_imu.py).  Those cases hold the
free-running poses to looser bounds, each with its measured deviation
beside it, and hold a second run, each scan of the port starting from the
JAX front-end's state (`run_both(carry_imu_state=True)`), to 1e-3 m and
0.01 deg.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_port_helpers as H
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.config import ImuConfig as JImu
from lio_slam_tpu.io import bag_replay as jbag_replay
from lio_slam_tpu.io import rosbag as jrb
from lio_slam_tpu.pipeline import imu_frontend as jfe
from lio_slam_tpu.pipeline.runner import Runner as JaxRunner
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch import convert
from lio_slam_tpu_torch.config import ImuConfig
from lio_slam_tpu_torch.io import formats
from lio_slam_tpu_torch.io import rosbag as rb
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.io import bag_replay as port_bag_replay
from lio_slam_tpu_torch.io.bag_replay import BagTopics
from lio_slam_tpu_torch.io.synthetic_bag import write_synthetic_bag
from lio_slam_tpu_torch.pipeline import gps_fusion as gf
from lio_slam_tpu_torch.pipeline import imu_frontend as fe
from lio_slam_tpu_torch.pipeline import synthetic_mission as sm
from lio_slam_tpu_torch.pipeline.runner import Runner


def small_cfg(m, **kw):
    """The config of tests/test_runner.py."""
    return m.Config(
        static=m.StaticConfig(max_raw_points=2048, max_scan_points=2048,
                              max_map_points=8192, max_keyframes=16,
                              max_keyframe_points=1024, max_loop_queue=2,
                              max_gps_queue=2, window_size=8,
                              max_imu_window=32),
        registration=m.RegistrationConfig(degeneracy_eig_thresh=10.0), **kw)


def scan_of(xyz, stamp):
    n = len(xyz)
    return formats.StandardScan(
        xyz=xyz.astype(np.float32), intensity=np.zeros(n, np.float32),
        ring=np.zeros(n, np.uint16), time=np.zeros(n, np.float32),
        stamp=float(stamp))


def imu_between(poses, stamps, i, g):
    """tests/test_runner.py's window: 10 samples of the truth increment's
    rates ending exactly at scan i's stamp."""
    inc = H.truth_increment(poses[i - 1], poses[i])
    T = 10
    t0, t1 = float(stamps[i - 1]), float(stamps[i])
    return {"acc": np.tile([0, 0, g], (T, 1)).astype(np.float32),
            "gyr": np.tile(inc[:3] / (t1 - t0), (T, 1)).astype(np.float32),
            "stamps": np.linspace(t0, t1, T + 1)[1:]}


def corridor_world(seed=0, length=80.0, half_w=4.0, n=60000):
    """The test's corridor: two parallel walls and a ground along x."""
    rs = np.random.RandomState(seed)
    u = lambda k, lo, hi: rs.uniform(lo, hi, k).astype(np.float32)
    ground = np.stack([u(n, -10, length), u(n, -half_w, half_w),
                       np.zeros(n, np.float32)], 1)
    wall = lambda y: np.stack([u(n // 2, -10, length),
                               np.full(n // 2, y, np.float32),
                               u(n // 2, 0, 4)], 1)
    w = np.concatenate([ground, wall(-half_w), wall(half_w)])
    return w + rs.randn(*w.shape).astype(np.float32) * 0.01


def test_degenerate_corridor_contract(tmp_path):
    """Down a corridor the eigenvalue gate fires, the poses stay finite,
    the cross-corridor drift stays small and the degenerate flag reaches
    the recorded odometry's covariance[0]; the port's recorded bag holds
    what the JAX run's does."""
    world = corridor_world()
    n = 8
    poses = np.zeros((n, 6), np.float32)
    poses[:, 3] = np.arange(n) * 2.0
    stamps = np.arange(n, dtype=np.float64)
    rs = np.random.RandomState(3)
    g = port_config.ImuConfig().gravity
    steps = []
    for i in range(n):
        xyz, mask = synthetic.observe(world, poses[i], 2048, rng=rs)
        steps.append((scan_of(xyz[mask], stamps[i]),
                      imu_between(poses, stamps, i, g) if i else None))
    bags = {k: str(tmp_path / f"{k}.bag") for k in ("port", "jax")}
    port_runner = Runner(small_cfg(port_config), device="cpu", loop_every=100,
                         record_bag=bags["port"])
    jax_runner = JaxRunner(small_cfg(jax_config), loop_every=100,
                           record_bag=bags["jax"])
    port, ref = H.run_both(port_runner, jax_runner, steps)
    port_runner.close_bag()
    jax_runner.close_bag()
    est = np.stack([r.pose for r in port.results])
    flags = [r.degenerate for r in port.results]
    assert np.isfinite(est).all()
    assert any(flags[2:]), f"matP never fired: {flags}"
    assert np.abs(est[:, 4:6] - poses[:, 4:6]).max() < 0.1
    covs = [rb.decode_odometry(m.raw).pose_covariance[0] for m in
            rb.BagReader(bags["port"]).read_messages(["/liorf/mapping/odometry"])]
    assert len(covs) == n
    assert any(c == 1.0 for c in covs[2:]), "covariance[0] flag never recorded"
    jcovs = [jrb.decode_odometry(m.raw).pose_covariance[0] for m in
             jrb.BagReader(bags["jax"]).read_messages(["/liorf/mapping/odometry"])]
    assert covs == jcovs
    H.assert_runs_match(port, ref)


def test_degenerate_correction_noise_inflated():
    """The front-end trusts a degenerate lidar correction less
    (correctionNoise2, imuPreintegration.cpp:288/:415): after identical
    histories a jumpy pose moves the state less when flagged, by as much
    as in the JAX front-end."""
    cfg = ImuConfig()
    correct, _, _ = fe.make_frontend(cfg)
    jcorrect, _, _ = jfe.make_frontend(JImu())
    W = 16
    acc = torch.tensor([0.0, 0.0, cfg.gravity]).repeat(W, 1)
    gyr = torch.zeros((W, 3))
    dt = torch.full((W,), 0.01)
    mask = torch.ones(W, dtype=torch.bool)
    base = fe.init_state()
    for _ in range(6):
        base = correct(base, acc, gyr, dt, mask, torch.zeros(6),
                       torch.tensor(False))
    jump = torch.tensor([0.0, 0.0, 0.0, 0.5, 0.0, 0.0])
    moved = {}
    for degenerate in (False, True):
        st = correct(base, acc, gyr, dt, mask, jump, torch.tensor(degenerate))
        moved[degenerate] = float(torch.linalg.norm(st.nav.p))
    assert moved[True] < 0.5 * moved[False], moved

    jbase = jfe.init_state()
    ja = jnp.asarray(acc.numpy())
    jargs = (ja, jnp.zeros((W, 3)), jnp.full(W, 0.01), jnp.ones(W, bool))
    for _ in range(6):
        jbase = jcorrect(jbase, *jargs, jnp.zeros(6), jnp.asarray(False))
    carried = convert.from_numpy(jax.tree.map(np.asarray, jbase))
    for degenerate in (False, True):
        st = jcorrect(jbase, *jargs, jnp.asarray(jump.numpy()),
                      jnp.asarray(degenerate))
        ref = float(jnp.linalg.norm(st.nav.p))
        # free-running: measured 3.5e-3 relative (0.20153 against 0.20082
        # m) and 5.8e-3 when degenerate (0.003356 against 0.003337 m): the
        # JAX front-end's float32 first update
        np.testing.assert_allclose(moved[degenerate], ref, rtol=1e-2)
        st = correct(carried, acc, gyr, dt, mask, jump,
                     torch.tensor(degenerate))
        np.testing.assert_allclose(float(torch.linalg.norm(st.nav.p)), ref,
                                   rtol=1e-5)


def both_runners():
    return (Runner(small_cfg(port_config), device="cpu", loop_every=100),
            JaxRunner(small_cfg(jax_config), loop_every=100))


def sequence_steps(seq, g, gyro_bias=None):
    steps = []
    for i in range(len(seq.stamps)):
        m = seq.scan_masks[i]
        imu = None
        if i:
            imu = imu_between(seq.poses, seq.stamps, i, g)
            if gyro_bias is not None:
                imu["gyr"] = imu["gyr"] + np.array([0.0, 0.0, gyro_bias(i)],
                                                   np.float32)
        steps.append((scan_of(seq.scans[i][m], seq.stamps[i]), imu))
    return steps


def test_imu_bias_ramp_mission():
    """A gyro bias ramping to 0.05 rad/s corrupts every guess; registration
    absorbs it (ATE bounded) without tripping the failure detector."""
    seq = synthetic.make_sequence(n_scans=10, n_points=2048, seed=1)
    g = port_config.ImuConfig().gravity
    steps = sequence_steps(seq, g, gyro_bias=lambda i: 0.05 * (i / 9.0))
    port, ref = H.run_both(*both_runners(), steps)
    est = np.stack([r.pose for r in port.results])
    ate = synthetic.ate_rmse(est, sm.relative_truth(seq))
    assert ate < 0.15, f"bias-ramp ATE {ate:.3f}"
    assert not port.runner.mapping_error
    # free-running: measured 1.65e-3 m / 0.021 deg (see the docstring)
    H.assert_runs_match(port, ref, atol_m=2e-3, atol_rad=np.radians(0.03))
    H.assert_runs_match(*H.run_both(*both_runners(), steps,
                                    carry_imu_state=True))


def test_aggressive_rotation_mission():
    """About 0.9 rad/s of yaw: the pipeline keeps tracking."""
    seq = synthetic.make_sequence(n_scans=10, n_points=2048, seed=2,
                                  yaw_rate=0.9, speed=1.5)
    steps = sequence_steps(seq, port_config.ImuConfig().gravity)
    port, ref = H.run_both(*both_runners(), steps)
    est = np.stack([r.pose for r in port.results])
    ate = synthetic.ate_rmse(est, sm.relative_truth(seq))
    assert ate < 0.2, f"aggressive-rotation ATE {ate:.3f}"
    assert not port.runner.mapping_error
    # free-running: measured 2.62e-3 m / 0.066 deg (see the docstring)
    H.assert_runs_match(port, ref, atol_m=3e-3, atol_rad=np.radians(0.08))
    H.assert_runs_match(*H.run_both(*both_runners(), steps,
                                    carry_imu_state=True))


def jam_replay(runner, bag_replay, path, topics):
    modes, sources, poses = [], [], []
    for r in bag_replay.replay_bag(runner, path, topics):
        modes.append(int(runner.fsm.mode))
        poses.append(r.pose)
        if runner.gps_intake.datum is not None:
            sources.append(runner.sensor_fusion_output(0.0)[1])
    return modes, sources, np.stack(poses)


def test_gps_jam_recover_replay(tmp_path):
    """An epoch-stamped bag with a corrected-GPS outage while the raw
    stream keeps arriving: the FSM walks NORMAL -> JAMMED -> RECOVERING ->
    NORMAL and the sensor_fusion_output source flips to 'fusion' during
    the jam (gpsDataHandler :616-726), mode for mode as the JAX replay.

    Free-running the poses keep within 0.2 m and 0.75 deg of the JAX
    replay's (measured 0.163 m / 0.585 deg): one scan a second at 1.5 m/s,
    the GN loop ends at its 30-iteration cap on scans 2, 4 and 5, and from
    scan 5 on the two runs hold a constant offset; scan 3 is the first
    where they part (3.95e-3 m), after the first corrections of the
    front-end.  With the JAX front-end's state carried into each scan the
    replays agree within 1e-3 m and 0.01 deg (measured 5.1e-6 m)."""
    path = str(tmp_path / "jam.bag")
    write_synthetic_bag(path, n_scans=24, n_points=2048, seed=0,
                        scan_period=1.0, gps=True, gps_jam=(8.0, 13.0),
                        raw_gps_topic="/gpsdata", speed=1.5)
    gps = dict(use_gps=True, gps_cov_threshold=5.0, gps_waiting_time=1.0,
               gps_data_waiting_time=2.0)
    topics = BagTopics(gps="/gps/fix", raw_gps="/gpsdata")
    jtopics = jbag_replay.BagTopics(gps="/gps/fix", raw_gps="/gpsdata")

    def runners():
        return (Runner(small_cfg(port_config, gps=port_config.GpsConfig(**gps)),
                       device="cpu", loop_every=100),
                JaxRunner(small_cfg(jax_config, gps=jax_config.GpsConfig(**gps)),
                          loop_every=100))

    port, ref = runners()
    modes, sources, poses = jam_replay(port, port_bag_replay, path, topics)
    assert gf.MODE_JAMMED in modes, f"never jammed: {modes}"
    assert gf.MODE_RECOVERING in modes, f"never recovered: {modes}"
    assert modes[-1] == gf.MODE_NORMAL, f"did not return to normal: {modes}"
    first_jam = modes.index(gf.MODE_JAMMED)
    assert gf.MODE_NORMAL in modes[:first_jam]
    assert "fusion" in sources and "raw" in sources
    with H.repaired_jax_feed():
        jmodes, jsources, jposes = jam_replay(ref, jbag_replay, path, jtopics)
    assert (modes, sources) == (jmodes, jsources)
    H.assert_poses_match(poses, jposes, atol_m=0.2, atol_rad=np.radians(0.75))
    assert int(port.state.gps_count) == int(ref.state.gps_count)
    assert int(port.state.store.count) == int(ref.state.store.count)

    port, ref = runners()
    states = H.record_imu_states(ref)
    with H.repaired_jax_feed():
        jmodes, jsources, jposes = jam_replay(ref, jbag_replay, path, jtopics)
    H.carry_imu_states(port, states)
    modes, sources, poses = jam_replay(port, port_bag_replay, path, topics)
    assert (modes, sources) == (jmodes, jsources)
    H.assert_poses_match(poses, jposes)
