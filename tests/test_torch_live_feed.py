"""The port's live sensor feed (`lio_slam_tpu_torch/pipeline/live.py`): the
cases of tests/test_live_feed.py on `Runner(device="cpu")`, one stream
through the JAX and the port `LiveFeed` into a recording stub Runner (the
same IMU windows and GPS pairings, exactly, the JAX feed with the port's
repaired window start), the repair itself (the unpatched JAX feed hands an
IMU sample to two consecutive corrections, the port's never), and the
native-queue choice (`use_native`)."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from lio_slam_tpu.pipeline import live as jlive
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch.io import formats, native, synthetic
from lio_slam_tpu_torch.ops import _build
from lio_slam_tpu_torch.pipeline import gps_fusion as gf
from lio_slam_tpu_torch.pipeline.live import (LiveFeed, _PySampleQueue,
                                              correction_takes)
from lio_slam_tpu_torch.pipeline.runner import Runner
from lio_slam_tpu_torch.utils import se3


def small_cfg(**kw):
    return dataclasses.replace(H.small_config(port_config), **kw)


def cpu_runner(cfg):
    return Runner(cfg, device="cpu", loop_every=100)


def scan_at(seq, i):
    m = seq.scan_masks[i]
    return formats.StandardScan(
        xyz=seq.scans[i][m], intensity=np.zeros(int(m.sum()), np.float32),
        ring=np.zeros(int(m.sum()), np.uint16),
        time=np.zeros(int(m.sum()), np.float32), stamp=float(seq.stamps[i]))


def imu_between(seq, i, g):
    """tests/test_runner.py's IMU window: 10 samples over (t[i-1], t[i]]."""
    inc = se3.pose6_between(torch.from_numpy(seq.poses[i - 1]),
                            torch.from_numpy(seq.poses[i])).numpy()
    T = 10
    t0, t1 = float(seq.stamps[i - 1]), float(seq.stamps[i])
    return {"acc": np.tile([0, 0, g], (T, 1)).astype(np.float32),
            "gyr": np.tile(inc[:3] / (t1 - t0), (T, 1)).astype(np.float32),
            "stamps": np.linspace(t0, t1, T + 1)[1:]}


class TestQueueParity:
    def make_stream(self, n=200, seed=0):
        rs = np.random.RandomState(seed)
        ts = np.cumsum(rs.uniform(0.001, 0.005, n)) + 1.7e9
        vals = rs.randn(n, 10).astype(np.float32)
        return ts, vals

    def test_native_matches_python_twin(self):
        ts, vals = self.make_stream()
        nq = native.SampleQueue(10, 4096)
        pq = _PySampleQueue(10, 4096)
        for t, v in zip(ts, vals):
            nq.push(t, v)
            pq.push(t, v)
        for (t0, t1) in [(ts[0], ts[50]), (ts[40], ts[120]),
                         (ts[100], ts[-1])]:
            nt, nv = nq.window(t0, t1, margin=0.0)
            pt, pv = pq.window(t0, t1, margin=0.0)
            np.testing.assert_allclose(nt, pt)
            np.testing.assert_allclose(nv, pv)
        assert len(nq) == len(pq)

    def test_stale_pop_is_permanent(self):
        q = native.SampleQueue(10, 64)
        for i in range(10):
            q.push(float(i), np.full(10, i, np.float32))
        q.window(5.0, 9.0, margin=0.0)
        ts, _ = q.window(0.0, 9.0, margin=0.0)
        assert ts.min() >= 5.0


class TestLiveFeed:
    def test_delay_buffer_and_flush(self):
        runner = cpu_runner(small_cfg())
        feed = LiveFeed(runner, use_native=False)
        seq = synthetic.make_sequence(n_scans=3, n_points=2048, seed=0)
        assert feed.push_scan(scan_at(seq, 0)) is None      # buffer fills
        r1 = feed.push_scan(scan_at(seq, 1))                # processes scan 0
        assert r1 is not None
        r2 = feed.flush()                                   # final scan
        assert r2 is not None
        assert feed.flush() is None
        assert len(runner.trajectory) == 2

    @pytest.mark.parametrize("use_native", [False, True])
    def test_mission_matches_direct_path(self, use_native):
        """LiveFeed(scans+IMU) == direct process_scan with hand-built
        windows: the queue/delay plumbing must not change the estimate."""
        seq = synthetic.make_sequence(n_scans=6, n_points=2048, seed=0)
        cfg = small_cfg()
        direct = cpu_runner(cfg)
        direct_poses = []
        for i in range(6):
            imu = imu_between(seq, i, cfg.imu.gravity) if i else None
            direct_poses.append(direct.process_scan(scan_at(seq, i), imu=imu).pose)

        live = cpu_runner(cfg)
        feed = LiveFeed(live, use_native=use_native)
        assert feed.native_active == use_native
        results = []
        for i in range(6):
            if i:
                imu = imu_between(seq, i, cfg.imu.gravity)
                for k in range(len(imu["stamps"])):
                    feed.push_imu(imu["stamps"][k], imu["acc"][k],
                                  imu["gyr"][k])
            r = feed.push_scan(scan_at(seq, i))
            if r is not None:
                results.append(r.pose)
        results.append(feed.flush().pose)
        assert len(results) == 6
        np.testing.assert_allclose(np.stack(results), np.stack(direct_poses),
                                   atol=1e-4)

    def test_gps_pairing_window(self):
        cfg = small_cfg(gps=port_config.GpsConfig(use_gps=True))
        runner = cpu_runner(cfg)
        feed = LiveFeed(runner, use_native=False)
        seq = synthetic.make_sequence(n_scans=3, n_points=2048, seed=0)
        feed.push_gps(float(seq.stamps[0]), 39.9, 116.3, 50.0,
                      covariance=np.ones(3))
        feed.push_scan(scan_at(seq, 0))
        feed.push_scan(scan_at(seq, 1))     # processes scan 0 w/ paired fix
        assert runner.gps_intake.datum is not None
        # a stale fix (>0.5 s away) is not paired
        feed2 = LiveFeed(cpu_runner(cfg), use_native=False)
        feed2.push_gps(float(seq.stamps[0]) - 5.0, 39.9, 116.3, 50.0)
        feed2.push_scan(scan_at(seq, 0))
        feed2.push_scan(scan_at(seq, 1))
        assert feed2.runner.gps_intake.datum is None

    def test_gps_queue_scan_semantics_50hz(self):
        """addGPSFactor queue-scan parity (mapOptmization.cpp:1961-1976): at
        GPS rates above scan rate EVERY in-window fix reaches the intake as a
        candidate, stale fixes pop permanently, newer fixes stay queued for
        the next scan."""
        cfg = small_cfg(gps=port_config.GpsConfig(use_gps=True))
        runner = cpu_runner(cfg)
        feed = LiveFeed(runner, use_native=False)
        seq = synthetic.make_sequence(n_scans=3, n_points=2048, seed=0)
        t0 = float(seq.stamps[0])
        seen = []
        orig = runner.gps_intake.on_fix
        runner.gps_intake.on_fix = \
            lambda s, *a, **k: (seen.append(s), orig(s, *a, **k))[1]
        for k in range(31):
            feed.push_gps(t0 - 0.299 + k * 0.02, 39.9 + k * 1e-7, 116.3, 50.0,
                          covariance=np.ones(3))
        feed.push_scan(scan_at(seq, 0))
        feed.push_scan(scan_at(seq, 1))     # processes scan 0
        assert len(seen) == 20
        assert runner.gps_intake._datum_fixed
        assert all(ts > t0 + 0.2 for (ts, *_) in feed._gps_queue)
        assert len(feed._gps_queue) == 6


class RecordingRunner:
    """What a LiveFeed hands its Runner: every process_scan call and raw
    GPS record, with the FSM's corrected-side stamps."""

    def __init__(self):
        self.calls, self.raw = [], []
        self.fsm = gf.PositioningModeFSM(port_config.GpsConfig())
        self.gps_marks = []
        self.fsm.on_gps = self.gps_marks.append

    def process_scan(self, scan, imu=None, gps_fixes=None):
        self.calls.append((scan.stamp, imu, gps_fixes))
        return len(self.calls)

    def on_raw_gps(self, t, lat, lon, alt, heading=None):
        self.raw.append((t, lat, lon, alt, heading))
        return 0


def feed_stream(feed, seed=0, n_scans=12):
    """A 10 Hz stream at epoch stamps: 100 Hz IMU with quaternions (absent
    from scans 5-7, so that scan 6's window has none), jittered and
    duplicated samples, a dropout, GPS at 50 Hz with covariances, raw GPS,
    a repeated and a backwards lidar stamp."""
    rs = np.random.RandomState(seed)
    t0 = 1.7e9 + 0.123
    out = []
    for i in range(n_scans):
        ts = t0 + 0.1 * i
        for k in range(10):
            t = ts + 0.01 * k + rs.uniform(-0.002, 0.002)
            if 0.6 <= t - t0 < 0.7:
                continue                               # IMU dropout
            quat = None if i in (5, 6, 7) else rs.randn(4)
            acc, gyr = rs.randn(3), rs.randn(3)
            feed.push_imu(t, acc, gyr, quat)
            if k % 4 == 3:
                feed.push_imu(t, acc, gyr, quat)       # duplicate
        for k in range(5):
            feed.push_gps(ts + 0.02 * k + 0.007, 31.0 + rs.rand() * 1e-4,
                          121.0, 10.0, status=k % 2, covariance=rs.rand(3))
        feed.push_raw_gps(ts + 0.02, 31.0, 121.0, 10.0, heading=90.0 + i)
        xyz = rs.randn(50, 3).astype(np.float32)
        scan = formats.StandardScan(xyz, np.zeros(50, np.float32),
                                    np.zeros(50, np.uint16),
                                    np.sort(rs.uniform(0, 0.1, 50)).astype(
                                        np.float32), ts)
        out.append(feed.push_scan(scan))
        if i in (3, 7):
            out.append(feed.push_scan(scan))           # repeated stamp
            out.append(feed.push_scan(dataclasses.replace(
                scan, stamp=ts - 0.05)))               # backwards
    out.append(feed.flush())
    return out


def test_live_feed_hands_the_runner_what_the_jax_feed_does():
    ja, tb = RecordingRunner(), RecordingRunner()
    with H.repaired_jax_feed():
        out_j = feed_stream(jlive.LiveFeed(ja, use_native=False))
    out_t = feed_stream(LiveFeed(tb, use_native=True))
    assert out_t == out_j and len(tb.calls) == 12
    assert tb.raw == ja.raw and tb.gps_marks == ja.gps_marks
    for (sa, ia, ga), (sb, ib, gb) in zip(ja.calls, tb.calls):
        assert sa == sb
        assert (ia is None) == (ib is None)
        if ia is not None:
            assert sorted(ia) == sorted(ib)
            for k in ("stamps", "acc", "gyr"):
                np.testing.assert_array_equal(ib[k], ia[k])
            assert (ia["quat"] is None) == (ib["quat"] is None)
            if ia["quat"] is not None:
                np.testing.assert_array_equal(ib["quat"], ia["quat"])
        assert (ga is None) == (gb is None)
        for fa, fb in zip(ga or [], gb or []):
            assert fa[:5] == fb[:5]
            np.testing.assert_array_equal(fa[5], fb[5])
    assert any(c[1] is not None and c[1]["quat"] is None for c in tb.calls)


def taken_twice(calls):
    """IMU stamps that two consecutive corrections both integrate: those
    of each window that `correction_takes` at its scan's stamp, shared
    with the next scan's."""
    taken = [set() if imu is None else
             set(imu["stamps"][correction_takes(imu["stamps"], stamp)])
             for stamp, imu, _ in calls]
    return [sorted(a & b) for a, b in zip(taken, taken[1:]) if a & b]


@pytest.mark.parametrize("use_native", [False, True])
def test_boundary_sample_reaches_one_correction_only(use_native):
    """At epoch stamps the bag writer's IMU sample lands one float64 ulp
    (2.4e-7 s) after a scan stamp.  The unpatched JAX feed starts the next
    window 1e-9 s after the stamp, which adds nothing there, while the
    correction takes samples up to 1e-6 s past it: the sample reaches two
    corrections.  The port's window starts after what the correction took
    (a stated departure, `live.py`'s docstring)."""
    def stream(feed):
        t0 = 1.7e9
        for i in range(8):
            ts = t0 + 0.1 * i
            for k in range(10):
                t = np.nextafter(ts, np.inf) if k == 0 else ts + 0.01 * k
                feed.push_imu(t, np.zeros(3), np.zeros(3))
            feed.push_scan(formats.StandardScan(
                np.ones((4, 3), np.float32), np.zeros(4, np.float32),
                np.zeros(4, np.uint16), np.full(4, 0.05, np.float32), ts))
        feed.flush()

    ja, tb = RecordingRunner(), RecordingRunner()
    stream(jlive.LiveFeed(ja, use_native=False))
    stream(LiveFeed(tb, use_native=use_native))
    assert len(tb.calls) == len(ja.calls) == 8
    assert len(taken_twice(ja.calls)) == 7
    assert taken_twice(tb.calls) == []
    # nothing else is lost: every sample reaches exactly one correction
    # (all but the last scan's tail)
    taken = np.concatenate([c[1]["stamps"][correction_takes(c[1]["stamps"], c[0])]
                            for c in tb.calls if c[1] is not None])
    assert len(taken) == len(np.unique(taken)) == 7 * 10 + 1


def test_use_native_true_raises_where_the_runtime_does_not_build(monkeypatch):
    """`use_native=True` demands the native queue; `None` takes it where it
    builds and the python twin where it does not."""
    assert LiveFeed(RecordingRunner()).native_active
    monkeypatch.setattr(native, "_lib", None)

    def no_compiler():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(_build, "load_host_runtime", no_compiler)
    with pytest.raises(RuntimeError, match="g.. not found"):
        LiveFeed(RecordingRunner(), use_native=True)
    assert not LiveFeed(RecordingRunner()).native_active
    assert not LiveFeed(RecordingRunner(), use_native=False).native_active
