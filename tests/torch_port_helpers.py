"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Each test builds its inputs with numpy from a seed and hands the same
arrays to the JAX function (on the CPU) and to its counterpart in
`lio_slam_tpu_torch`.  Torch runs single-threaded: the suite runs under
several pytest-xdist workers at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

torch.set_num_threads(1)


def to_jax_config(cfg, jax_config_module):
    """The JAX package's Config with the same values as a port Config."""
    parts = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            cls = getattr(jax_config_module, type(v).__name__)
            v = cls(**{g.name: getattr(v, g.name) for g in dataclasses.fields(v)})
        parts[f.name] = v
    return jax_config_module.Config(**parts)


def small_config(config_module):
    """The small mission config of tests/test_runner.py, loop closure off."""
    m = config_module
    return m.Config(
        static=m.StaticConfig(max_raw_points=2048, max_scan_points=2048,
                              max_map_points=8192, max_keyframes=16,
                              max_keyframe_points=1024, max_loop_queue=2,
                              max_gps_queue=2, window_size=8,
                              max_imu_window=32),
        registration=m.RegistrationConfig(degeneracy_eig_thresh=10.0),
        loop=m.LoopClosureConfig(enabled=False))


def t(x, dtype=None):
    """numpy -> CPU tensor (copy)."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def n(x):
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def planar_scene(seed=0, n_map=4096, n_scan=512):
    """Ground plane + wall + noise (the scene of tests/test_fused_corr.py)."""
    rs = np.random.RandomState(seed)
    g = np.stack([rs.uniform(-20, 20, n_map // 2),
                  rs.uniform(-20, 20, n_map // 2),
                  rs.randn(n_map // 2) * 0.01], 1)
    w = np.stack([np.full(n_map // 2, 8.0) + rs.randn(n_map // 2) * 0.01,
                  rs.uniform(-20, 20, n_map // 2),
                  rs.uniform(0, 5, n_map // 2)], 1)
    map_pts = np.concatenate([g, w]).astype(np.float32)
    sel = rs.permutation(n_map)[:n_scan]
    scan = (map_pts[sel] + rs.randn(n_scan, 3) * 0.02).astype(np.float32)
    return map_pts, scan


def repaired_jax_window_for(self, scan):
    """The JAX `LiveFeed._window_for` with the port's window start: after
    the samples the previous scan's correction took
    (`lio_slam_tpu_torch.pipeline.live.correction_takes`), not 1e-9 s after
    its stamp, which at epoch stamps hands the sample one float64 ulp after
    the stamp to two corrections.  The JAX package stays as it is; its
    replays are compared with the port's under this patch."""
    from lio_slam_tpu_torch.pipeline.live import correction_takes

    sweep_end = float(scan.stamp) + (float(scan.time.max())
                                     if scan.time is not None
                                     and len(scan.time) else 0.0)
    last = self._last_scan_stamp
    ts, vals = self.imu_queue.window(
        last if last is not None else -1e18,
        sweep_end + self.deskew_tail_margin, margin=0.0, max_n=4096)
    if last is not None and len(ts):
        fresh = ~correction_takes(ts, last)
        ts, vals = ts[fresh], vals[fresh]
    if len(ts) == 0:
        return None
    quat = vals[:, 6:10]
    return {"stamps": ts, "acc": vals[:, 0:3].copy(),
            "gyr": vals[:, 3:6].copy(),
            "quat": None if np.isnan(quat).all() else quat.copy()}


@contextlib.contextmanager
def repaired_jax_feed():
    """The JAX `LiveFeed` with `repaired_jax_window_for` inside the block."""
    from lio_slam_tpu.pipeline import live as jlive

    original = jlive.LiveFeed._window_for
    jlive.LiveFeed._window_for = repaired_jax_window_for
    try:
        yield
    finally:
        jlive.LiveFeed._window_for = original


def jax_fused_interpret(scan, scan_mask, grid, cfg):
    """The JAX `registration._maybe_fused` as it is off the CPU, with the
    Pallas kernel in interpret mode: patched in where a JAX run must hold
    its candidate block for `corr_refresh_every` iterations, as the port
    does (on the CPU the JAX registration takes its unfused path, which
    finds fresh correspondences at every iteration)."""
    from lio_slam_tpu.ops import fused_corr as jfc
    from lio_slam_tpu.utils import se3 as jse3

    if grid is None or not cfg.use_fused_kernel:
        return None
    kw = dict(halo=cfg.grid_halo, nn_radius=cfg.nn_radius,
              plane_dist_thresh=cfg.plane_dist_thresh,
              robust_weight_floor=cfg.robust_weight_floor, interpret=True)
    if cfg.corr_refresh_every <= 1:
        return lambda pose: jfc.fused_normal_equations(grid, scan, scan_mask,
                                                       pose, **kw)

    def gather_fn(pose):
        R, t = jse3.pose6_to_Rt(pose)
        return jfc.gather_planar(grid, jse3.transform_points(R, t, scan),
                                 cfg.grid_halo)

    def from_cand_fn(cand, hh, pose):
        return jfc.fused_ne_from_candidates(cand, hh, scan, scan_mask, pose,
                                            **kw)

    return (gather_fn, from_cand_fn, int(cfg.corr_refresh_every))


def truth_increment(pose_a, pose_b) -> np.ndarray:
    """pose6_between of two truth poses, in float32 numpy (the port's se3
    on CPU tensors): the IMU windows the robustness missions build from it
    are handed to both packages as the same arrays."""
    from lio_slam_tpu_torch.utils import se3

    return se3.pose6_between(torch.from_numpy(np.asarray(pose_a, np.float32)),
                             torch.from_numpy(np.asarray(pose_b, np.float32))
                             ).numpy()


class MissionRun(NamedTuple):
    runner: object
    results: list          # ScanResult a scan
    mapping_error: list    # runner.mapping_error after each scan
    modes: list            # runner.fsm.mode after each scan


def run_mission(runner, steps) -> MissionRun:
    """`runner.process_scan(scan, imu=imu)` over (scan, imu) steps."""
    results, errors, modes = [], [], []
    for scan, imu in steps:
        results.append(runner.process_scan(scan, imu=imu))
        errors.append(bool(runner.mapping_error))
        modes.append(int(runner.fsm.mode))
    return MissionRun(runner, results, errors, modes)


def record_imu_states(jax_runner) -> list:
    """Wrap the JAX runner's `process_scan` so that the returned list
    collects its front-end state (numpy leaves) before each call."""
    import jax

    states = []
    process = jax_runner.process_scan

    def recording(*args, **kwargs):
        states.append(jax.tree.map(np.asarray, jax_runner.imu_state))
        return process(*args, **kwargs)

    jax_runner.process_scan = recording
    return states


def carry_imu_states(port_runner, states: list):
    """Wrap the port runner's `process_scan` so that call k starts from the
    front-end state `states[k]` (from `record_imu_states`): the mapping
    path alone against the reference's."""
    from lio_slam_tpu_torch import convert

    process = port_runner.process_scan
    calls = iter(states)

    def carried(*args, **kwargs):
        port_runner.imu_state = convert.from_numpy(next(calls),
                                                    port_runner.device)
        return process(*args, **kwargs)

    port_runner.process_scan = carried


def run_both(port_runner, jax_runner, steps, carry_imu_state=False):
    """(port run, JAX run) of the same steps.  With `carry_imu_state` each
    scan of the port starts from the JAX front-end's state before that
    scan (`carry_imu_states`)."""
    if not carry_imu_state:
        return run_mission(port_runner, steps), run_mission(jax_runner, steps)
    states = record_imu_states(jax_runner)
    ref = run_mission(jax_runner, steps)
    carry_imu_states(port_runner, states)
    return run_mission(port_runner, steps), ref


# poses of the two packages' missions: the parity limits of the port's
# robustness mirrors (tests/test_torch_fault_injection.py and the others)
POSE_ATOL_M = 1e-3
POSE_ATOL_RAD = math.radians(0.01)


def assert_poses_match(port_poses, jax_poses, atol_m=POSE_ATOL_M,
                       atol_rad=POSE_ATOL_RAD):
    p, j = np.asarray(port_poses), np.asarray(jax_poses)
    assert p.shape == j.shape and np.isfinite(p).all()
    dt = float(np.abs(p[..., 3:] - j[..., 3:]).max())
    dr = float(np.abs(p[..., :3] - j[..., :3]).max())
    assert dt <= atol_m and dr <= atol_rad, (
        f"poses {dt:.3e} m / {math.degrees(dr):.3e} deg from the JAX run")


def assert_runs_match(port: MissionRun, ref: MissionRun,
                      atol_m=POSE_ATOL_M, atol_rad=POSE_ATOL_RAD):
    """What both packages' runs of one mission must share: every scan's
    pose (within the limits above unless the caller states others),
    degenerate and keyframe flags, `mapping_error` and FSM mode after each
    scan, and the keyframe and eviction counts at the end."""
    assert len(port.results) == len(ref.results)
    assert_poses_match([r.pose for r in port.results],
                       [r.pose for r in ref.results], atol_m, atol_rad)
    assert [r.degenerate for r in port.results] == \
        [bool(r.degenerate) for r in ref.results]
    assert [r.is_keyframe for r in port.results] == \
        [bool(r.is_keyframe) for r in ref.results]
    assert port.mapping_error == ref.mapping_error
    assert port.modes == ref.modes
    assert int(port.runner.state.store.count) == int(ref.runner.state.store.count)
    assert int(port.runner.state.evict_count) == int(ref.runner.state.evict_count)
    assert port.runner.keyframe_evictions == ref.runner.keyframe_evictions


# ---- the sharded tests' ranks (tests/torch_dist_workers.py) ----

class RankRun:
    """Rank processes started by `spawn_ranks`; `results()` waits for them
    (at most until the deadline) and returns each rank's results."""

    def __init__(self, procs, workdir, world, deadline_s):
        self.procs, self.workdir, self.world = procs, workdir, world
        self.deadline = __import__("time").monotonic() + deadline_s
        self._results = None

    def _logs(self) -> str:
        import os

        out = []
        for r in range(self.world):
            path = os.path.join(self.workdir, f"rank{r}.log")
            with open(path, errors="replace") as f:
                out.append(f"--- rank {r} ---\n" + f.read()[-4000:])
        return "\n".join(out)

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def close(self):
        """Kill the ranks still running (a module fixture's teardown)."""
        self._kill()

    def results(self) -> list:
        """[rank 0's {case: results}, rank 1's, ...].  A rank that fails
        ends the others at once (a rank waiting in a collective would
        otherwise wait out its timeout); past the deadline every rank is
        killed.  Either way the ranks' output is in the raised error."""
        import os
        import pickle
        import time

        if self._results is not None:
            return self._results
        while True:
            codes = [p.poll() for p in self.procs]
            if any(c not in (None, 0) for c in codes):
                self._kill()
                raise AssertionError(f"a rank failed (exit codes {codes}):\n"
                                     + self._logs())
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > self.deadline:
                self._kill()
                raise AssertionError("the ranks passed their deadline and "
                                     "were killed:\n" + self._logs())
            time.sleep(0.05)
        self._results = []
        for r in range(self.world):
            with open(os.path.join(self.workdir, f"result_{r}.pkl"), "rb") as f:
                self._results.append(pickle.load(f))
        return self._results


def spawn_ranks(world: int, workdir, cases: list,
                deadline_s: float = 120.0) -> RankRun:
    """Start `world` gloo ranks of tests/torch_dist_workers.py in `workdir`
    (a fresh directory: the rendezvous is a FileStore there, not a TCP
    port) running `cases`, a list of (name, mesh shape, keyword
    arguments); returns at once.  The ranks import torch and the port
    only."""
    import os
    import pickle
    import subprocess
    import sys

    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "torch_dist_workers.py")
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(os.path.join(workdir, f"rank{r}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, worker, "--rank", str(r), "--world", str(world),
             "--dir", workdir], cwd=root, env=env, stdout=log,
            stderr=subprocess.STDOUT))
        log.close()
    return RankRun(procs, workdir, world, deadline_s)


def rank_results(run: RankRun, case: str) -> list:
    """Every rank's results of `case`."""
    return [res[case] for res in run.results()]
