"""Two 60-scan circuits of the port's Runner past its keyframe capacity
(the missions of tests/test_archive.py, which the JAX package marks slow;
here about 50 s each on one CPU thread), with the JAX tests' assertions:
only the archive can close the loop once the first lap is evicted, and its
anchors share the unary region with live GPS factors without evicting
them.  Run by the port alone: the JAX runs take minutes on the CPU."""

import json

import numpy as np

from test_torch_archive import circuit_cfg, circuit_seq, feed
from torch_port_helpers import n, t
from lio_slam_tpu_torch.config import GpsConfig
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.pipeline.runner import Runner
from lio_slam_tpu_torch.utils import enu as enu_mod
from lio_slam_tpu_torch.utils import se3


def test_mission_archive_closes_cross_eviction_loop(tmp_path):
    """A circuit whose lap exceeds the device store: by the revisit the
    first lap is evicted and only the archive can close the loop."""
    cfg = circuit_cfg()
    n_scans = 60
    seq = circuit_seq(n_scans)
    log_path = str(tmp_path / "mission.jsonl")
    runner = Runner(cfg, device="cpu", loop_every=5, fetch_every=2,
                    mission_log=log_path)
    feed(runner, seq, 0, n_scans, imu=True)
    runner.drain()
    h = runner.health()
    assert h["keyframe_evictions"] > 0, "test needs eviction pressure"
    assert h["archived_keyframes"] > cfg.static.max_keyframes
    assert not h["loop_memory_exhausted"]
    assert runner.archive_loops >= 1
    assert not runner.mapping_error
    assert np.isfinite(np.stack(runner.trajectory)).all()
    assert len(runner.trajectory) == n_scans
    runner.close()
    recs = [json.loads(line) for line in open(log_path)]
    assert len([r for r in recs if "event" not in r]) == n_scans
    arch = [r for r in recs if r.get("source") == "archive"]
    assert len(arch) == runner.archive_loops
    for e in arch:
        assert e["fitness"] < cfg.loop.fitness_score
        assert e["i"] > e["j"], "query keyframe is newer than the match"
    assert runner.timer.stats["archive_loop"].count == n_scans // 5


def test_archive_anchor_gps_coexistence():
    """A GPS-fused circuit past capacity with archive loops firing: anchors
    live in their own unary slots, so no live GPS factor is evicted by an
    anchor (and the reverse), and the trajectory stays consistent."""
    cfg = circuit_cfg(gps=GpsConfig(use_gps=True, gps_cov_threshold=5.0,
                                    pose_cov_threshold=-1.0,
                                    gps_distance_frequency=1.0,
                                    min_travel_before_gps=1.0,
                                    first_fix_average=1))
    n_scans = 60
    seq = circuit_seq(n_scans)
    lc = enu_mod.LocalCartesian(31.0, 121.0, 10.0)
    rs = np.random.RandomState(0)
    fixes = [(*lc.reverse((seq.poses[i, 3:] + rs.randn(3) * 0.05).astype(np.float64)), 0)
             for i in range(n_scans)]
    runner = Runner(cfg, device="cpu", loop_every=5, fetch_every=2)
    feed(runner, seq, 0, n_scans, imu=True, fixes=fixes)
    runner.drain()
    assert runner.health()["keyframe_evictions"] > 0
    assert runner.archive_loops >= 1, "archive loops must fire"
    g = runner.state.graph
    A = cfg.static.max_archive_anchors
    gmask = n(g.gps_mask)
    G = gmask.shape[0]
    assert int(runner.state.gps_count) >= 3
    assert gmask[:G - A].sum() >= 1, "live GPS factors must survive"
    assert gmask[G - A:].sum() >= 1, "anchor must occupy a dedicated slot"
    assert (n(g.gps_i)[gmask] < int(runner.state.store.count)).all()
    assert not runner.mapping_error
    traj = np.stack(runner.trajectory)
    assert np.isfinite(traj).all()
    rel = np.stack([se3.pose6_between(t(seq.poses[0]), t(p)).numpy()
                    for p in seq.poses])
    ate = synthetic.ate_rmse(traj, rel)
    assert ate < 2.5, f"GPS+archive mission inconsistent: ATE {ate}"
