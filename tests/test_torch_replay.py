"""The port's batch replay (`pipeline/replay.HostDrivenReplay`) against the
JAX package's.

- 8 scans of `make_sequence(n_points=2048)` at the config of
  tests/test_replay.py, the loop detector every 4 scans, through both
  packages' `HostDrivenReplay` on the same numpy batch: poses within 1e-3 m
  and 0.01 deg (measured 9.2e-7 m, 1.4e-7 rad), the same GN iterations and
  degenerate flags, the TransformFusion output within 1e-3 (measured
  7.8e-5).
- The deskew mission of tests/test_sweep_sensor.py (slow there, 19 s here
  on the port alone): with the sweep's point times the ATE is under 0.2 m,
  and with zeros (deskew off) at least 4.5 times larger, the JAX test's
  own gates; the deskewed ATE within 10 % of the JAX replay's of the same
  scans (`fixtures/hard_replay_jax.npz`).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H  # noqa: F401  (single-threaded torch)
from torch_port_helpers import n
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.pipeline import replay as jreplay
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.pipeline import replay
from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "lio_slam_tpu_torch", "fixtures", "hard_replay_jax.npz")


def replay_config(m):
    """The config of tests/test_replay.py."""
    return m.Config(
        static=m.StaticConfig(max_raw_points=2048, max_scan_points=2048,
                              max_map_points=8192, max_keyframes=16,
                              max_keyframe_points=1024, max_loop_queue=2,
                              max_gps_queue=2, window_size=8,
                              max_imu_window=16),
        registration=m.RegistrationConfig(degeneracy_eig_thresh=10.0))


def numpy_batch(seq, cfg, n_scans):
    W = cfg.static.max_imu_window
    P = cfg.static.max_raw_points
    acc, gyr, dts, rel_t, imask = synthetic.make_imu_windows(
        seq, W, samples_per_scan=8, gravity=cfg.imu.gravity)
    return replay.ReplayBatch(
        xyz=seq.scans[:n_scans], ptime=np.zeros((n_scans, P), np.float32),
        pmask=seq.scan_masks[:n_scans],
        ring=np.zeros((n_scans, P), np.int32), acc=acc[:n_scans],
        gyr=gyr[:n_scans], dts=dts[:n_scans], rel_t=rel_t[:n_scans],
        imask=imask[:n_scans], stamp=seq.stamps[:n_scans])


def test_host_driven_replay_matches_jax():
    n_scans = 8
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=0)
    batch = numpy_batch(seq, replay_config(port_config), n_scans)

    jhd = jreplay.HostDrivenReplay(replay_config(jax_config), loop_every=4)
    jstate, jfes = jhd.init()
    jstate, jfes, jout = jhd.run(jstate, jfes, jhd.split(jreplay.ReplayBatch(
        *(jnp.asarray(a) for a in batch))))

    hd = replay.HostDrivenReplay(replay_config(port_config), loop_every=4,
                                 device="cpu")
    scans = hd.split(batch)
    assert all(a.device.type == "cpu" for a in scans[0])
    state, fes = hd.init()
    state, fes, out = hd.run(state, fes, scans)

    poses, ref = n(out.poses), np.asarray(jout.poses)
    assert poses.shape == (n_scans, 6) and np.isfinite(poses).all()
    assert np.abs(poses[:, 3:] - ref[:, 3:]).max() < 1e-3
    assert np.abs(poses[:, :3] - ref[:, :3]).max() < np.radians(0.01)
    np.testing.assert_array_equal(n(out.iters), np.asarray(jout.iters))
    assert int(n(out.iters).max()) >= 1
    np.testing.assert_array_equal(n(out.degenerate), np.asarray(jout.degenerate))
    np.testing.assert_allclose(n(out.fused_last), np.asarray(jout.fused_last),
                               atol=1e-3)
    assert int(state.loop_count) == int(jstate.loop_count)
    assert int(state.store.count) == int(jstate.store.count)
    assert bool(fes.initialized) and not bool(fes.failure)
    assert synthetic.ate_rmse(poses, sm.relative_truth(seq)) < 0.15


def test_replay_needs_a_card_unless_asked():
    cfg = replay_config(port_config)
    if torch.cuda.is_available():
        assert replay.HostDrivenReplay(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            replay.HostDrivenReplay(cfg)


def test_deskew_matters_end_to_end():
    cfg, seq, windows = sm.deskew_mission_inputs()
    truth = sm.relative_truth(seq)

    def ate(ptimes):
        hd = replay.HostDrivenReplay(cfg, loop_every=0, device="cpu")
        state, fes = hd.init()
        _, _, out = hd.run(state, fes, hd.split(sm.replay_batch(seq, windows,
                                                                ptimes)))
        return synthetic.ate_rmse(n(out.poses), truth)

    ate_with = ate(None)
    ate_without = ate(np.zeros_like(seq.ptimes))
    assert np.isfinite(ate_with) and np.isfinite(ate_without)
    assert ate_with < 0.2, f"deskewed pipeline too inaccurate: {ate_with}"
    assert ate_without >= 4.5 * ate_with, (ate_with, ate_without)
    ref = float(np.load(FIXTURE)["deskew_ate_with_m"])
    assert abs(ate_with - ref) <= 0.1 * ref, (ate_with, ref)
