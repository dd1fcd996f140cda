"""GPS fusion of the port against the JAX package: the numpy-only copies
(utils/enu, pipeline/gps_fusion) on the same fix stream, the GPS factor's
gates and slot allocation (`pipeline/lio._add_gps_factor`), and the mapping
step with GPS factors (the scenario of tests/test_gps_fusion.py).

Tolerances: the host modules are copies, so equal to the bit; graph slots
and counts identical; poses of the 14-scan mission within 2e-3 (float32,
measured 3e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import n, small_config, t
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.io import synthetic as jsynthetic
from lio_slam_tpu.pipeline import gps_fusion as jgf
from lio_slam_tpu.pipeline import lio as jlio
from lio_slam_tpu.utils import enu as jenu
from lio_slam_tpu.utils import pointcloud as jpc
from lio_slam_tpu.utils import se3 as jse3
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch import convert
from lio_slam_tpu_torch.io import synthetic as tsynthetic
from lio_slam_tpu_torch.pipeline import gps_fusion as tgf
from lio_slam_tpu_torch.pipeline import lio as tlio
from lio_slam_tpu_torch.utils import enu as tenu
from lio_slam_tpu_torch.utils import pointcloud as tpc


# --------------------------------------------------------------------------
# host modules: copies
# --------------------------------------------------------------------------

def test_local_cartesian_copy_equal():
    rs = np.random.RandomState(0)
    a, b = jenu.LocalCartesian(48.1, 11.5, 520.0), tenu.LocalCartesian(48.1, 11.5, 520.0)
    for _ in range(20):
        p = rs.uniform(-5000, 5000, 3)
        np.testing.assert_array_equal(np.asarray(b.reverse(p)), np.asarray(a.reverse(p)))
        lla = a.reverse(p)
        np.testing.assert_array_equal(np.asarray(b.forward(*lla)),
                                      np.asarray(a.forward(*lla)))
        np.testing.assert_allclose(np.asarray(b.forward(*lla)), p, atol=1e-6)
    for yaw in (-3.0, -0.5, 0.0, 1.2, 3.1):
        assert tenu.heading_from_yaw(yaw) == jenu.heading_from_yaw(yaw)
    assert set(x for x in dir(jenu) if not x.startswith("_")) \
        == set(x for x in dir(tenu) if not x.startswith("_"))


def fix_stream(seed=1, count=60):
    """Fixes of a vehicle leaving the datum: noise, a status dropout, a jump,
    some with a covariance."""
    rs = np.random.RandomState(seed)
    lc = tenu.LocalCartesian(39.9, 116.4, 50.0)
    out = []
    for k in range(count):
        pos = np.array([0.4 * k, 0.1 * k, 0.0]) + rs.randn(3) * 0.05
        if k == 40:
            pos[0] += 6.0                                 # a jump
        lat, lon, alt = lc.reverse(pos)
        status = -1 if k in (17, 18) else 0
        cov = np.array([0.5, 3.0, 1.0]) if k % 9 == 4 else None
        out.append((0.1 * k, float(lat), float(lon), float(alt), status, cov))
    return out


def test_gps_intake_copy_equal():
    a = jgf.GpsIntake(jax_config.GpsConfig(use_gps=True))
    b = tgf.GpsIntake(port_config.GpsConfig(use_gps=True))
    seen = 0
    for k, (stamp, lat, lon, alt, status, cov) in enumerate(fix_stream()):
        oa = a.on_fix(stamp, lat, lon, alt, status, covariance=cov,
                      mode_normal=k % 13 != 0)
        ob = b.on_fix(stamp, lat, lon, alt, status, covariance=cov,
                      mode_normal=k % 13 != 0)
        assert (oa is None) == (ob is None)
        if oa is None:
            continue
        seen += 1
        assert ob.stamp == oa.stamp and ob.accurate == oa.accurate
        np.testing.assert_array_equal(ob.enu, oa.enu)
        np.testing.assert_array_equal(ob.covariance, oa.covariance)
    assert seen == 58 and not ob.accurate is None
    np.testing.assert_array_equal(b.datum, a.datum)
    # the jump at fix 40 was flagged, its neighbours not
    c = tgf.GpsIntake(port_config.GpsConfig(use_gps=True))
    flags = [c.on_fix(*f[:5], covariance=f[5]) for f in fix_stream()]
    assert not flags[40].accurate and flags[39].accurate and flags[42].accurate


def test_positioning_fsm_and_fusion_output_copy_equal():
    a = jgf.PositioningModeFSM(jax_config.GpsConfig())
    b = tgf.PositioningModeFSM(port_config.GpsConfig())
    modes = []
    for k in range(200):
        now = 0.1 * k
        if not 30 <= k < 80:                  # the corrected stream drops out
            a.on_gps(now), b.on_gps(now)
        assert b.step(now, now) == a.step(now, now)
        assert b.converging == a.converging
        assert b.select_source(10.0, 12.0) == a.select_source(10.0, 12.0)
        assert b.select_source(10.0, 20.0, switch_gps_data=False) \
            == a.select_source(10.0, 20.0, switch_gps_data=False)
        modes.append(b.mode)
    assert {tgf.MODE_NORMAL, tgf.MODE_JAMMED, tgf.MODE_RECOVERING} <= set(modes)
    assert (tgf.MODE_NORMAL, tgf.MODE_JAMMED, tgf.MODE_RECOVERING) \
        == (jgf.MODE_NORMAL, jgf.MODE_JAMMED, jgf.MODE_RECOVERING)
    pose = np.array([0.01, -0.02, np.pi / 2, 100.0, 200.0, 5.0])
    oa = jgf.fusion_gps_output(pose, 1.5, jenu.LocalCartesian(39.9, 116.4, 50.0), 1)
    ob = tgf.fusion_gps_output(pose, 1.5, tenu.LocalCartesian(39.9, 116.4, 50.0), 1)
    assert dataclasses.asdict(ob) == dataclasses.asdict(oa)


def test_gps_fixes_from_truth_feed_the_intake():
    """The loop mission's fixes: five at the start fix the datum at the
    origin, and every later fix projects back to its truth position within
    the noise."""
    truth = np.stack([np.linspace(0, 30, 31), np.linspace(0, 5, 31),
                      np.zeros(31)], 1)
    stamps = np.arange(31) * 0.1
    fixes = tsynthetic.gps_fixes_from_truth(truth, stamps, seed=3, noise=0.05)
    assert len(fixes) == 31 and len(fixes[0]) == 5 and len(fixes[7]) == 1
    again = tsynthetic.gps_fixes_from_truth(truth, stamps, seed=3, noise=0.05)
    assert again == fixes
    intake = tgf.GpsIntake(port_config.GpsConfig(use_gps=True))
    for i, per_scan in enumerate(fixes):
        for f in per_scan:
            obs = intake.on_fix(*f[:5], covariance=f[5])
        assert obs.accurate
        assert np.abs(obs.enu - truth[i]).max() < 0.3, i


# --------------------------------------------------------------------------
# the GPS factor
# --------------------------------------------------------------------------

def gps_config(m, **gps):
    base = small_config(m)
    kw = dict(use_gps=True, pose_cov_threshold=-1.0, gps_distance_frequency=1.0,
              min_travel_before_gps=1.0)
    kw.update(gps)
    return dataclasses.replace(base, gps=m.GpsConfig(**kw))


def state_with_keyframes(count=6, seed=0):
    """A JAX LioState (numpy leaves) with `count` keyframes 1 m apart and a
    chain graph over them."""
    rs = np.random.RandomState(seed)
    st = jax.tree.map(np.array, jlio.init_state(gps_config(jax_config)))
    st.store.poses[:count, 3] = np.arange(count)
    st.store.poses[:count, :3] = rs.randn(count, 3) * 0.01
    st.store.count[...] = count
    st.graph.poses[:] = st.store.poses
    st.graph.pose_mask[:count] = True
    st.graph.prior_info[:] = [100, 100, 0.1, 1e-8, 1e-8, 1e-8]
    st.graph.bt_i[:count - 1] = np.arange(count - 1)
    st.graph.bt_j[:count - 1] = np.arange(1, count)
    st.graph.bt_meas[:count - 1, 3] = 1.0
    st.graph.bt_info[:count - 1] = [1e6, 1e6, 1e6, 1e4, 1e4, 1e4]
    st.graph.bt_mask[:count - 1] = True
    st.last_gps_pos[:] = [-100.0, 0.0, 0.0]
    return st


def gps_input(mod, arr, pos, valid=True):
    z3 = np.zeros(3, np.float32)
    return mod.ScanInput(cloud=None, stamp=arr(np.float32(0)),
                         init_guess=arr(np.zeros(6, np.float32)),
                         guess_valid=arr(np.bool_(False)), imu_rpy=arr(z3),
                         imu_available=arr(np.bool_(False)),
                         gps_pos=arr(np.asarray(pos, np.float32)),
                         gps_info=arr(np.array([1.0, 0.5, 0.25], np.float32)),
                         gps_valid=arr(np.bool_(valid)))


def add_both(st, new_idx, pos, valid=True, **gps):
    jcfg, tcfg = gps_config(jax_config, **gps), gps_config(port_config, **gps)
    ja = jlio._add_gps_factor(jax.tree.map(jnp.asarray, st),
                              gps_input(jlio, jnp.asarray, pos, valid),
                              jnp.int32(new_idx), jcfg, jlio.default_map_ops(jcfg))
    tb = tlio._add_gps_factor(convert.from_numpy(st),
                              gps_input(tlio, t, pos, valid),
                              t(np.int32(new_idx)), tcfg,
                              tlio.default_map_ops(tcfg, "cpu"))
    for name in ("gps_i", "gps_mask", "gps_meas", "gps_info"):
        np.testing.assert_array_equal(n(getattr(tb.graph, name)),
                                      n(getattr(ja.graph, name)), err_msg=name)
    assert int(tb.gps_count) == int(ja.gps_count)
    assert bool(tb.loop_closed) == bool(ja.loop_closed)
    np.testing.assert_array_equal(n(tb.last_gps_pos), n(ja.last_gps_pos))
    return jax.tree.map(np.array, ja), tb


def test_gps_factor_gates_match():
    st = state_with_keyframes()
    _, tb = add_both(st, 5, [5.0, 0.1, 9.0])
    assert int(tb.gps_count) == 1 and bool(tb.loop_closed)
    assert n(tb.graph.gps_i)[0] == 5 and n(tb.graph.gps_mask)[0]
    # x/y from the fix, z from the estimate (use_gps_elevation off)
    np.testing.assert_array_equal(n(tb.graph.gps_meas)[0],
                                  np.array([5.0, 0.1, st.store.poses[5, 5]],
                                           np.float32))
    _, tb = add_both(st, 5, [5.0, 0.1, 9.0], use_gps_elevation=True)
    assert n(tb.graph.gps_meas)[0, 2] == 9.0
    for kw, idx in ((dict(valid=False), 5),                      # no fix
                    (dict(min_travel_before_gps=50.0), 5),       # too near the start
                    (dict(pose_cov_threshold=1e9), 5)):          # pose certain enough
        _, tb = add_both(st, idx, [5.0, 0.1, 0.0], **kw)
        assert int(tb.gps_count) == 0 and not bool(tb.loop_closed)
        assert not n(tb.graph.gps_mask).any()
    near = state_with_keyframes()
    near.last_gps_pos[:] = near.store.poses[5, 3:] + [0.5, 0, 0]  # spacing
    _, tb = add_both(near, 5, [5.0, 0.1, 0.0])
    assert int(tb.gps_count) == 0


def test_gps_slot_allocation_free_first_then_ring_anchors_untouched():
    """The first free slot of the live region; with none free, the ring over
    the live region recycles the oldest; the anchor slots at the tail are
    never written."""
    st = state_with_keyframes()
    G = st.graph.gps_i.shape[0]
    anchors = gps_config(port_config).static.max_archive_anchors
    live = G - anchors
    assert live == 16 and anchors == 8
    st.graph.gps_mask[live:] = True                   # anchors in place
    st.graph.gps_i[live:] = 3
    st.graph.gps_meas[live:] = 7.0
    st.graph.gps_mask[:live] = True
    st.graph.gps_mask[[4, 9]] = False                 # two slots freed by eviction
    st.gps_count[...] = 21
    ja, tb = add_both(st, 5, [5.0, 0.0, 0.0], gps_distance_frequency=0.5)
    assert n(tb.graph.gps_mask)[4] and not n(tb.graph.gps_mask)[9]
    assert n(tb.graph.gps_i)[4] == 5
    ja, tb = add_both(ja, 4, [4.0, 0.0, 0.0], gps_distance_frequency=0.5)
    assert n(tb.graph.gps_mask)[9] and n(tb.graph.gps_i)[9] == 4
    # none free: the ring slot gps_count % live = 23 % 16 = 7
    ja, tb = add_both(ja, 3, [3.0, 0.0, 0.0], gps_distance_frequency=0.5)
    assert int(tb.gps_count) == 24 and n(tb.graph.gps_i)[7] == 3
    np.testing.assert_array_equal(n(tb.graph.gps_meas)[7, :2], [3.0, 0.0])
    np.testing.assert_array_equal(n(tb.graph.gps_i)[live:], 3)
    np.testing.assert_array_equal(n(tb.graph.gps_meas)[live:], 7.0)
    assert n(tb.graph.gps_mask)[live:].all()


def test_first_free_returns_the_first_false():
    for mask in ([True, True, False, True, False], [False, True], [True, True],
                 [False]):
        idx, free = tlio._first_free(t(np.array(mask)))
        assert int(idx) == int(np.argmin(mask)) and bool(free) == (not all(mask))


# --------------------------------------------------------------------------
# the mapping step with GPS factors
# --------------------------------------------------------------------------

def test_gps_pulls_trajectory_in_the_mapping_step():
    """tests/test_gps_fusion.py's mission (14 scans, 4096 points, GPS = the
    anchored truth) through both steps, then the full correction."""
    def cfg_of(m):
        cfg = m.Config(
            static=m.StaticConfig(
                max_raw_points=4096, max_scan_points=4096, max_map_points=16384,
                max_keyframes=32, max_keyframe_points=2048, max_loop_queue=4,
                max_gps_queue=8, window_size=16),
            registration=m.RegistrationConfig(degeneracy_eig_thresh=10.0))
        return dataclasses.replace(cfg, gps=m.GpsConfig(
            use_gps=True, pose_cov_threshold=-1.0, gps_distance_frequency=1.0,
            min_travel_before_gps=1.0))

    jcfg, tcfg = cfg_of(jax_config), cfg_of(port_config)
    seq = jsynthetic.make_sequence(n_scans=14, n_points=4096, seed=0, speed=3.0)
    jstep, tstep = jlio.make_lio_step(jcfg), tlio.make_lio_step(tcfg)
    ja, tb = jlio.init_state(jcfg), tlio.init_state(tcfg)
    prev = [None, None]
    for i in range(14):
        rel = n(jse3.pose6_between(jnp.asarray(seq.poses[0]),
                                   jnp.asarray(seq.poses[i])))
        inps = []
        for k, (mod, pcm, arr) in enumerate(((jlio, jpc, jnp.asarray),
                                             (tlio, tpc, t))):
            if i == 0:
                guess, gvalid = np.zeros(6, np.float32), False
            else:
                inc = jse3.pose6_between(jnp.asarray(seq.poses[i - 1]),
                                         jnp.asarray(seq.poses[i]))
                guess = n(jse3.pose6_compose(jnp.asarray(prev[k]), inc))
                gvalid = True
            inps.append(mod.ScanInput(
                cloud=pcm.Cloud(xyz=arr(seq.scans[i]), mask=arr(seq.scan_masks[i])),
                stamp=arr(np.float32(seq.stamps[i])), init_guess=arr(guess),
                guess_valid=arr(np.bool_(gvalid)), imu_rpy=arr(seq.imu_rpy[i]),
                imu_available=arr(np.bool_(True)),
                gps_pos=arr(rel[3:].astype(np.float32)),
                gps_info=arr(np.full(3, 100.0, np.float32)),
                gps_valid=arr(np.bool_(True))))
        ja, oa = jstep(ja, inps[0])
        tb, ob = tstep(tb, inps[1])
        prev = [n(oa.pose), n(ob.pose)]
        assert ob.is_keyframe == bool(oa.is_keyframe)
        assert ob.registration_iters == int(oa.registration_iters)
        np.testing.assert_allclose(prev[1], prev[0], atol=2e-3)
        assert int(tb.gps_count) == int(ja.gps_count)
        assert bool(tb.needs_full_solve) == bool(ja.needs_full_solve)
    assert int(tb.gps_count) >= 1 and bool(tb.graph.gps_mask.any())
    for name in ("gps_i", "gps_mask"):
        np.testing.assert_array_equal(n(getattr(tb.graph, name)),
                                      n(getattr(ja.graph, name)))
    np.testing.assert_allclose(n(tb.graph.gps_meas), n(ja.graph.gps_meas), atol=2e-3)
    assert bool(tb.needs_full_solve)
    ja = jlio.make_full_correction(jcfg)(ja)
    tb = tlio.make_full_correction(tcfg, device="cpu")(tb)
    count = int(tb.store.count)
    np.testing.assert_allclose(n(tb.store.poses)[:count], n(ja.store.poses)[:count],
                               atol=2e-3)
    assert not bool(tb.needs_full_solve)
