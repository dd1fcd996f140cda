"""tests/test_capacity.py on the port, case for case: the keyframe store at
capacity evicts its oldest keyframe and rebases the graph instead of
corrupting it, and the GPS factor slots ring-allocate.

Each mission feeds the same scans through the port's `make_lio_step` (on
the CPU) and the JAX step, each with guesses composed from its own last
pose and the truth increment.  The JAX test's own assertions hold on the
port; keyframe flags, degenerate flags, keyframe, eviction and loop counts
and the graph invariants of `assert_graph_consistent` (the chain slots,
the active range, the loop region) are the JAX run's, and the poses stay
within 1e-3 m and 0.01 deg of it.  `test_long_mission_soak` is slow, as
in the JAX suite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from torch_port_helpers import n, t
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.graph import solver as jsolver
from lio_slam_tpu.pipeline import lio as jlio
from lio_slam_tpu.utils import pointcloud as jpc
from lio_slam_tpu.utils import se3 as jse3
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch import convert
from lio_slam_tpu_torch.graph import solver
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.pipeline import lio
from lio_slam_tpu_torch.pipeline import synthetic_mission as sm
from lio_slam_tpu_torch.utils import pointcloud as pc
from lio_slam_tpu_torch.utils import se3


def tiny_config(m, max_keyframes: int):
    """tests/test_capacity.py's config: every scan a keyframe."""
    return m.Config(
        static=m.StaticConfig(
            max_raw_points=2048, max_scan_points=2048, max_map_points=8192,
            max_keyframes=max_keyframes, max_keyframe_points=1024,
            max_loop_queue=2, max_gps_queue=1, window_size=4),
        registration=m.RegistrationConfig(max_iterations=6,
                                          degeneracy_eig_thresh=10.0),
        keyframe=m.KeyframeConfig(dist_threshold=0.05))


def port_mission(cfg, seq):
    step = lio.make_lio_step(cfg, device="cpu")
    state = lio.init_state(cfg, device="cpu")
    outs = []
    for i in range(len(seq.stamps)):
        if i == 0:
            guess, gvalid = torch.zeros(6), False
        else:
            inc = se3.pose6_between(t(seq.poses[i - 1]), t(seq.poses[i]))
            guess, gvalid = se3.pose6_compose(outs[-1].pose, inc), True
        inp = lio.ScanInput(
            cloud=pc.Cloud(xyz=t(seq.scans[i]), mask=t(seq.scan_masks[i])),
            stamp=torch.tensor(seq.stamps[i], dtype=torch.float32),
            init_guess=guess, guess_valid=torch.tensor(gvalid),
            imu_rpy=t(seq.imu_rpy[i]), imu_available=torch.tensor(True),
            gps_pos=torch.zeros(3), gps_info=torch.zeros(3),
            gps_valid=torch.tensor(False))
        state, out = step(state, inp)
        outs.append(out)
    return state, outs


def jax_mission(cfg, seq):
    step = jlio.make_lio_step(cfg)
    state = jlio.init_state(cfg)
    outs = []
    for i in range(len(seq.stamps)):
        if i == 0:
            guess, gvalid = np.zeros(6, np.float32), False
        else:
            inc = jse3.pose6_between(jnp.asarray(seq.poses[i - 1]),
                                     jnp.asarray(seq.poses[i]))
            guess = np.asarray(jse3.pose6_compose(
                jnp.asarray(np.asarray(outs[-1].pose)), inc))
            gvalid = True
        inp = jlio.ScanInput(
            cloud=jpc.Cloud(xyz=jnp.asarray(seq.scans[i]),
                            mask=jnp.asarray(seq.scan_masks[i])),
            stamp=jnp.float32(seq.stamps[i]),
            init_guess=jnp.asarray(guess), guess_valid=jnp.asarray(gvalid),
            imu_rpy=jnp.asarray(seq.imu_rpy[i]),
            imu_available=jnp.asarray(True),
            gps_pos=jnp.zeros(3), gps_info=jnp.zeros(3),
            gps_valid=jnp.asarray(False))
        state, out = step(state, inp)
        outs.append(out)
    return state, outs


def run_mission(max_keyframes: int, n_scans: int):
    """The mission of tests/test_capacity.py through both packages:
    (seq, port state, port outputs, JAX state, JAX outputs)."""
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=0,
                                  speed=2.0)
    state, outs = port_mission(tiny_config(port_config, max_keyframes), seq)
    jstate, jouts = jax_mission(tiny_config(jax_config, max_keyframes), seq)
    return seq, state, outs, jstate, jouts


def graph_invariants(state, K):
    """The invariants the round-2 capacity bug violated, as values: the
    count, the chain slots, whether every active factor is in range, the
    loops stored against the loop count, finiteness."""
    count = int(n(state.store.count))
    bt_i, bt_j = n(state.graph.bt_i), n(state.graph.bt_j)
    bt_mask = n(state.graph.bt_mask)
    active = bt_mask.nonzero()[0]
    return {
        "count": count,
        "chain": [(bool(bt_mask[i]), int(bt_i[i]), int(bt_j[i]))
                  for i in range(max(count - 1, 0))],
        "in_range": bool((bt_j[active] < count).all()
                         and (bt_i[active] < count).all()),
        "loops_stored": int(bt_mask[K - 1:].sum()),
        "loop_count": int(n(state.loop_count)),
        "finite": bool(np.isfinite(n(state.store.poses)).all()
                       and np.isfinite(n(state.graph.poses)).all()),
    }


def assert_graph_consistent(state, cfg):
    """tests/test_capacity.py's invariants on a state of either package."""
    K = cfg.static.max_keyframes
    g = graph_invariants(state, K)
    assert g["count"] <= K
    for i, (on, a, b) in enumerate(g["chain"]):
        assert on, f"chain slot {i} lost"
        assert (a, b) == (i, i + 1), f"chain slot {i} holds ({a},{b})"
    assert g["in_range"]
    assert g["loops_stored"] <= g["loop_count"]
    assert g["finite"]
    return g


def assert_missions_match(state, outs, jstate, jouts, cfg, **limits):
    jcfg = H.to_jax_config(cfg, jax_config)
    assert assert_graph_consistent(state, cfg) == \
        assert_graph_consistent(jstate, jcfg)
    assert [o.is_keyframe for o in outs] == [bool(o.is_keyframe) for o in jouts]
    assert [bool(o.degenerate) for o in outs] == \
        [bool(o.degenerate) for o in jouts]
    assert [int(o.evictions) for o in outs] == [int(o.evictions) for o in jouts]
    assert int(state.evict_count) == int(jstate.evict_count)
    H.assert_poses_match(np.stack([n(o.pose) for o in outs]),
                         np.stack([np.asarray(o.pose) for o in jouts]), **limits)
    count = int(state.store.count)
    H.assert_poses_match(n(state.store.poses[:count]),
                         np.asarray(jstate.store.poses[:count]), **limits)


def test_saturation_repro_capacity4():
    """The verdict's repro: capacity 4, 8 keyframes."""
    seq, state, outs, jstate, jouts = run_mission(4, 8)
    cfg = tiny_config(port_config, 4)
    assert int(state.store.count) == 4
    assert int(state.evict_count) == 4
    assert int(outs[-1].evictions) == 4
    assert int(state.loop_count) == 0
    assert_graph_consistent(state, cfg)
    stamps = n(state.store.stamps)[:4]
    assert (np.diff(stamps) > 0).all()
    np.testing.assert_allclose(stamps, seq.stamps[4:8], atol=1e-5)
    np.testing.assert_array_equal(stamps, np.asarray(jstate.store.stamps)[:4])
    assert_missions_match(state, outs, jstate, jouts, cfg)


def assert_tracks_and_solves(seq, state, outs, jstate, ate_limit, **limits):
    est = np.stack([n(o.pose) for o in outs])
    ate = synthetic.ate_rmse(est, sm.relative_truth(seq))
    assert ate < ate_limit, f"post-eviction drift {ate:.3f} m"
    res = solver.solve(state.graph, state.graph.pose_mask, iterations=3)
    assert np.isfinite(n(res.graph.poses)).all()
    assert float(res.chi2) < 1.0
    jres = jsolver.solve(jstate.graph, jstate.graph.pose_mask, iterations=3)
    H.assert_poses_match(n(res.graph.poses), np.asarray(jres.graph.poses),
                         **limits)
    np.testing.assert_allclose(float(res.chi2), float(jres.chi2), rtol=1e-3,
                               atol=1e-6)


def test_long_mission_3x_capacity_tracks():
    """3x capacity: the trajectory keeps tracking, the graph solves, the
    drift is bounded."""
    seq, state, outs, jstate, jouts = run_mission(6, 19)
    cfg = tiny_config(port_config, 6)
    assert int(state.evict_count) >= 2 * 6
    assert_graph_consistent(state, cfg)
    assert_tracks_and_solves(seq, state, outs, jstate, 0.2)
    assert_missions_match(state, outs, jstate, jouts, cfg)


def test_prior_rebase_anchors_survivor():
    """After eviction the prior anchors the new keyframe 0 near its
    estimate with about the original prior strength."""
    _, state, outs, jstate, jouts = run_mission(4, 6)
    cfg = tiny_config(port_config, 4)
    prior_pose = n(state.graph.prior_pose)
    assert np.linalg.norm(prior_pose[3:] - n(state.graph.poses[0])[3:]) < 0.3
    prior_var = 1.0 / n(state.graph.prior_info)
    orig_var = np.asarray(cfg.keyframe.prior_sigmas)
    assert (prior_var <= 2.05 * orig_var + 1e-3).all()
    assert (prior_var >= 0.999 * orig_var - 1e-3).all()
    H.assert_poses_match(prior_pose, np.asarray(jstate.graph.prior_pose))
    np.testing.assert_allclose(n(state.graph.prior_info),
                               np.asarray(jstate.graph.prior_info), rtol=1e-5)
    assert_missions_match(state, outs, jstate, jouts, cfg)


def chain_state(cfg, K):
    """The full chain 0..K-1 with a loop factor (2 <-> 5) in the loop
    region and a GPS factor at keyframe 1, as numpy leaves."""
    state = jax.tree.map(np.asarray, jlio.init_state(H.to_jax_config(
        cfg, jax_config)))
    poses = np.zeros((K, 6), np.float32)
    poses[:, 3] = np.arange(K, dtype=np.float32)
    g = state.graph
    bt_i, bt_j, bt_mask = g.bt_i.copy(), g.bt_j.copy(), g.bt_mask.copy()
    bt_i[:K - 1] = np.arange(K - 1)
    bt_j[:K - 1] = np.arange(1, K)
    bt_mask[:K - 1] = True
    bt_i[K - 1], bt_j[K - 1], bt_mask[K - 1] = 2, 5, True
    gps_i, gps_mask = g.gps_i.copy(), g.gps_mask.copy()
    gps_i[0], gps_mask[0] = 1, True
    g = g._replace(poses=poses, pose_mask=np.ones(K, bool), bt_i=bt_i,
                   bt_j=bt_j, bt_mask=bt_mask, gps_i=gps_i, gps_mask=gps_mask,
                   prior_info=np.asarray(jlio.F.info_from_variances(
                       cfg.keyframe.prior_sigmas)))
    store = state.store._replace(poses=poses,
                                 stamps=np.arange(K, dtype=np.float32),
                                 count=np.int32(K))
    return state._replace(graph=g, store=store,
                          sc_db=state.sc_db._replace(count=np.int32(K)))


def test_eviction_remaps_loop_and_gps_factors():
    """_evict_oldest keeps loop and GPS factors on the same physical
    keyframes after the shift and drops those touching the evicted pose,
    leaf for leaf as the JAX eviction."""
    K = 8
    cfg = tiny_config(port_config, K)
    start = chain_state(cfg, K)
    jstates = [jax.tree.map(jnp.asarray, start)]
    states = [convert.from_numpy(start)]
    for _ in range(3):
        jstates.append(jax.jit(jlio._evict_oldest)(jstates[-1]))
        states.append(lio._evict_oldest(states[-1]))
    evicted, ev2, ev3 = states[1:]
    assert int(evicted.store.count) == K - 1
    eg = evicted.graph
    for i in range(K - 2):
        assert bool(eg.bt_mask[i]) and int(eg.bt_i[i]) == i \
            and int(eg.bt_j[i]) == i + 1
    assert not bool(eg.bt_mask[K - 2])
    loop_slot = K - 1
    assert bool(eg.bt_mask[loop_slot])
    assert int(eg.bt_i[loop_slot]) == 1 and int(eg.bt_j[loop_slot]) == 4
    assert bool(eg.gps_mask[0]) and int(eg.gps_i[0]) == 0
    np.testing.assert_allclose(n(eg.prior_pose), start.store.poses[1],
                               atol=1e-6)
    assert not bool(ev2.graph.gps_mask[0])
    assert bool(ev2.graph.bt_mask[loop_slot])
    assert int(ev2.graph.bt_i[loop_slot]) == 0
    assert int(ev2.graph.bt_j[loop_slot]) == 3
    assert not bool(ev3.graph.bt_mask[loop_slot])
    for st, jst in zip(states[1:], jstates[1:]):
        for name in ("bt_i", "bt_j", "bt_mask", "gps_i", "gps_mask",
                     "pose_mask"):
            np.testing.assert_array_equal(n(getattr(st.graph, name)),
                                          np.asarray(getattr(jst.graph, name)),
                                          err_msg=name)
        for name in ("poses", "prior_pose", "prior_info", "bt_meas"):
            np.testing.assert_allclose(n(getattr(st.graph, name)),
                                       np.asarray(getattr(jst.graph, name)),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
        assert int(st.store.count) == int(jst.store.count)
        assert int(st.evict_count) == int(jst.evict_count)


@pytest.mark.slow
def test_long_mission_soak():
    """Endurance: a mission about 5x the store capacity; eviction churn
    neither breaks consistency nor accumulates drift.

    The poses keep within 2.5e-3 m and 0.03 deg of the JAX run's, not the
    1e-3 m and 0.01 deg of the short cases: measured 1.74e-3 m (scans
    80-89) and 0.021 deg (scans 100-109).  The two float32 registrations
    take the same GN iterations up to scan 66 and stay within 1.3e-5 m up
    to scan 39; from there the rounding of two implementations compounds
    along 96 evictions and prior rebases, and 8 scans after scan 66 take
    one GN iteration more or less.  The drift against truth is the same
    (ATE 0.07247 m, JAX 0.07250 m)."""
    seq, state, outs, jstate, jouts = run_mission(24, 120)
    cfg = tiny_config(port_config, 24)
    limits = dict(atol_m=2.5e-3, atol_rad=np.radians(0.03))
    assert int(state.evict_count) >= 90
    assert_graph_consistent(state, cfg)
    assert_tracks_and_solves(seq, state, outs, jstate, 0.5, **limits)
    assert_missions_match(state, outs, jstate, jouts, cfg, **limits)


def gps_ring(m, lio_mod, cfg, device_kw):
    """tests/test_capacity.py's GPS-slot ring through `_add_gps_factor` of
    either package: (gps_count, gps_i, gps_mask, live slots G)."""
    torch_side = lio_mod is lio
    state = lio_mod.init_state(cfg, **device_kw)
    G = state.graph.gps_i.shape[0] - cfg.static.max_archive_anchors
    K = cfg.static.max_keyframes
    poses = np.zeros((K, 6), np.float32)
    poses[:, 3] = np.arange(K) * 5.0
    arr = t if torch_side else jnp.asarray
    state = state._replace(store=state.store._replace(
        poses=arr(poses), count=arr(np.int32(K))))
    ops = lio_mod.default_map_ops(cfg, **device_kw)
    for k in range(G + 3):
        inp = lio_mod.ScanInput(
            cloud=m.Cloud(xyz=arr(np.zeros((4, 3), np.float32)),
                          mask=arr(np.zeros(4, bool))),
            stamp=arr(np.float32(k)), init_guess=arr(np.zeros(6, np.float32)),
            guess_valid=arr(np.bool_(False)),
            imu_rpy=arr(np.zeros(3, np.float32)),
            imu_available=arr(np.bool_(False)),
            gps_pos=arr(np.array([k * 5.0, 0.0, 0.0], np.float32)),
            gps_info=arr(np.ones(3, np.float32)),
            gps_valid=arr(np.bool_(True)))
        state = lio_mod._add_gps_factor(state, inp, arr(np.int32(k % K)),
                                        cfg, ops)
    return (int(state.gps_count), n(state.graph.gps_i),
            n(state.graph.gps_mask), G)


def test_gps_slot_ring_recycles_oldest():
    """GPS factors ring-allocate at capacity (the oldest recycled) instead
    of clamping onto the last slot; the archive anchors' tail stays
    untouched."""
    base = tiny_config(port_config, 16)
    gps = dict(use_gps=True, pose_cov_threshold=0.0,
               min_travel_before_gps=0.0, gps_distance_frequency=0.0)
    cfg = port_config.Config(static=base.static,
                             registration=base.registration,
                             keyframe=base.keyframe,
                             gps=port_config.GpsConfig(**gps))
    count, gps_i, gps_mask, G = gps_ring(pc, lio, cfg, dict(device="cpu"))
    assert count == G + 2
    assert gps_i[0] == G + 1 and gps_i[1] == G + 2 and gps_i[2] == 3
    assert gps_mask[:G].all()
    assert not gps_mask[G:].any()
    jcount, jgps_i, jgps_mask, _ = gps_ring(
        jpc, jlio, H.to_jax_config(cfg, jax_config), {})
    assert count == jcount
    np.testing.assert_array_equal(gps_i, jgps_i)
    np.testing.assert_array_equal(gps_mask, jgps_mask)
