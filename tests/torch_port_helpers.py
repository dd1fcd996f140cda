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
from torch.overrides import TorchFunctionMode

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


def small_layout_config(name):
    """The port's `small_config` under the gather layout `name` of
    `synthetic_mission.LAYOUT_MISSIONS` (tests/test_torch_gather_layouts.py's
    missions; `torch_port_make_fixture.py layouts` records the JAX runs)."""
    from lio_slam_tpu_torch import config as port_config
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    base = small_config(port_config)
    _, halo, cap, srt, ds = next(x for x in sm.LAYOUT_MISSIONS if x[0] == name)
    return dataclasses.replace(base, registration=dataclasses.replace(
        base.registration, grid_halo=halo, grid_max_per_cell=cap,
        sort_scan_by_cell=srt, scan_downsample=ds))


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


SMALL_REBUILD_SCANS = 8         # tests/test_torch_resident_modes.py's replays
SMALL_REBUILD_LOOP_EVERY = 4


def small_rebuild_inputs():
    """(port Config, numpy ReplayBatch) of tests/test_torch_resident_modes.py's
    replays against the JAX monolith: tests/test_replay.py's config on the
    rebuild-mode map, SMALL_REBUILD_SCANS scans of 2048 points
    (`torch_port_make_fixture.py rebuild` records the JAX run)."""
    from lio_slam_tpu_torch import config as port_config
    from lio_slam_tpu_torch.io import synthetic
    from test_torch_replay import numpy_batch, replay_config

    base = replay_config(port_config)
    cfg = dataclasses.replace(base, registration=dataclasses.replace(
        base.registration, local_map_mode="rebuild"))
    seq = synthetic.make_sequence(n_scans=SMALL_REBUILD_SCANS, n_points=2048,
                                  seed=0)
    return cfg, numpy_batch(seq, cfg, SMALL_REBUILD_SCANS)


def imu_state_of(ref, i, device=None):
    """The JAX front-end's state at the start of scan i, from a fixture's
    `imu_*` keys (`ref` maps the names without a prefix)."""
    from lio_slam_tpu_torch.ops import preintegration as pre
    from lio_slam_tpu_torch.pipeline import imu_frontend as fe

    get = lambda k: torch.from_numpy(np.array(ref[f"imu_{k}"][i])).to(device)
    return fe.ImuFrontendState(
        nav=pre.NavState(R=get("R"), p=get("p"), v=get("v")),
        bias_gyr=get("bias_gyr"), bias_acc=get("bias_acc"), cov=get("cov"),
        initialized=get("initialized"), failure=get("failure"))


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

    def __init__(self, procs, workdir, world, deadline_s, respawn=None):
        self.procs, self.workdir, self.world = procs, workdir, world
        self.deadline = __import__("time").monotonic() + deadline_s
        self._results = None
        # a TCP rendezvous picks its port by binding and closing a socket,
        # and another process may take the port before rank 0 binds it:
        # `respawn()` starts the ranks again on a fresh port, once, and only
        # when a rank's log shows the address in use
        self._respawn = respawn

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
                logs = self._logs()
                if self._respawn is not None and ADDRESS_IN_USE in logs.lower():
                    print(f"the rendezvous port was taken ({ADDRESS_IN_USE}):"
                          " spawning the ranks again on a fresh port",
                          flush=True)
                    self.procs, self._respawn = self._respawn(), None
                    continue
                raise AssertionError(f"a rank failed (exit codes {codes}):\n"
                                     + logs)
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


def arrays_sha256(*arrays) -> str:
    """sha256 of the arrays' dtypes, shapes and bytes, in order: a test
    checks with it that a fixture was made from its inputs."""
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


ADDRESS_IN_USE = "address already in use"


def free_port() -> int:
    """A TCP port no socket holds now (it may be taken before it is
    bound again)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(world: int, workdir, cases: list, deadline_s: float = 120.0,
                local_world_size: int | None = None) -> RankRun:
    """Start `world` gloo ranks of tests/torch_dist_workers.py in `workdir`
    running `cases`, a list of (name, mesh shape, keyword arguments);
    returns at once.  The ranks import torch and the port only.  By
    default they meet through a FileStore in `workdir` (a fresh
    directory); with `local_world_size` they join through
    `parallel.distributed.initialize` from the LIO_* variables (a TCP store
    on a free port, LOCAL_WORLD_SIZE and LOCAL_RANK set as torchrun sets
    them for hosts of that many ranks), spawned once more on a fresh port
    if the first one was taken."""
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

    def start():
        port = free_port()
        procs = []
        for r in range(world):
            args = ["--rank", str(r), "--world", str(world), "--dir", workdir]
            rank_env = env
            if local_world_size is not None:
                args += ["--rendezvous", "lio"]
                rank_env = dict(env, LIO_COORDINATOR=f"127.0.0.1:{port}",
                                LIO_NUM_PROCESSES=str(world),
                                LIO_PROCESS_ID=str(r),
                                LOCAL_WORLD_SIZE=str(local_world_size),
                                LOCAL_RANK=str(r % local_world_size))
            log = open(os.path.join(workdir, f"rank{r}.log"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, worker] + args, cwd=root, env=rank_env,
                stdout=log, stderr=subprocess.STDOUT))
            log.close()
        return procs

    return RankRun(start(), workdir, world, deadline_s,
                   respawn=start if local_world_size is not None else None)


def rank_results(run: RankRun, case: str) -> list:
    """Every rank's results of `case`."""
    return [res[case] for res in run.results()]


class HostReadGuard(TorchFunctionMode):
    """Raises where code under it would read the device from the host or
    copy host data to it, were its tensors on the card: `Tensor.__bool__`,
    `item`, `tolist`, `__int__` / `__float__` / `__index__`, `cpu`,
    `numpy`, `nonzero` (and the other ops whose output size depends on the
    data), indexing with a boolean mask or with a 0-dim integer tensor
    (which torch turns into a host integer with `item`), and tensors built
    from host data (`torch.tensor`, `as_tensor`, `from_numpy`, a host
    number assigned into a slot).  On the
    CPU none of these wait for anything; the guard finds them there for
    the device-resident replay, which a CUDA graph captures."""

    READS = {"__bool__", "item", "tolist", "__int__", "__float__",
             "__index__", "cpu", "numpy", "nonzero", "argwhere",
             "masked_select", "unique", "unique_consecutive", "bincount",
             "repeat_interleave", "tensor", "as_tensor", "from_numpy"}

    def __init__(self):
        super().__init__()
        self.seen = []

    @staticmethod
    def _host_index(index) -> bool:
        items = index if isinstance(index, tuple) else (index,)
        for x in items:
            if isinstance(x, torch.Tensor) and (
                    x.dtype == torch.bool
                    or (x.dim() == 0 and not x.is_floating_point())):
                return True
        return False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        bad = name in self.READS
        if name == "repeat_interleave":
            # an int count is static; a tensor of counts sizes the output
            reps = args[1] if len(args) > 1 else kwargs.get("repeats")
            bad = isinstance(reps, torch.Tensor)
        if name == "where" and len(args) == 1 and not kwargs:
            bad = True
        if name in ("__getitem__", "__setitem__", "index_put_", "index_put"):
            bad = self._host_index(args[1])
        if name == "__setitem__" and not isinstance(args[2], torch.Tensor):
            # a host number becomes a CPU tensor copied into the slot
            bad = True
        if bad:
            raise AssertionError(f"host read or host data on the resident "
                                 f"path: {name}")
        return func(*args, **kwargs)


def streamed_stage_case(case, cap, n_points=640, seed=0):
    """A table and 27 bucket ids a point, built by hand, for the cases the
    streamed stage (9 offsets a chunk) makes new.  Each point has 27
    buckets of its own; its four nearest neighbours lie on the plane 0.25 m
    below it and a fifth just off that plane, so the fifth's place decides
    the fit:
    - "tie": two candidates at exactly the fifth distance, one in the last
      offset of a chunk and one in the first of the next (offsets 8/9, or
      17/18 for odd points), in either order: the lower row wins.
    - "last_chunk": the five nearest all in offsets 18-26, nearer decoys
      than the rest of the map in offsets 0-17.
    - "duplicates": offsets that repeat the bucket of one of the first four
      offsets, ids below 0 and at or past the table's end, the five nearest
      spread over those four buckets.
    Returns (table, hh, scan, mask, pose) on the CPU (tests/test_torch_cuda.py
    and tests/test_torch_fused_corr_emulated.py)."""
    from lio_slam_tpu_torch.ops.voxel_grid import SENTINEL

    rs = np.random.RandomState(seed)
    O, N = 27, n_points
    T = O * N + 1
    table = np.full((T, cap, 3), SENTINEL, np.float32)
    hh = (np.arange(O)[:, None] + O * np.arange(N)[None, :]).astype(np.int32)
    # on a 1/8 m lattice, so that q + each offset below is exact and the
    # tied distances are equal to the bit
    scan = (rs.randint(-32, 33, (N, 3)) / 8.0).astype(np.float32)
    near = np.array([[0.25, 0, -0.25], [-0.25, 0, -0.25], [0, 0.25, -0.25],
                     [0, -0.375, -0.25]], np.float32)
    tie = np.array([[0.5, 0, -0.125], [0, -0.5, -0.125]], np.float32)
    fill = [0] * T

    def put(bucket, offset_xyz, q):
        table[bucket, fill[bucket] % cap] = q + offset_xyz
        fill[bucket] += 1

    for i in range(N):
        q = scan[i]
        b = hh[:, i]
        if case == "tie":
            for x in near:
                put(b[rs.randint(0, O)], x, q)
            lo, hi = (8, 9) if i % 2 == 0 else (17, 18)
            first, second = (tie if rs.rand() < 0.5 else tie[::-1])
            put(b[lo], first, q)
            put(b[hi], second, q)
        elif case == "last_chunk":
            for x in np.concatenate([near, tie[:1]]):
                put(b[rs.randint(18, O)], x, q)
            for _ in range(8):       # nearer than the nn gate, farther than all five
                put(b[rs.randint(0, 18)],
                    np.array([0.6, 0.0, -0.25], np.float32)
                    + rs.uniform(-0.05, 0.05, 3).astype(np.float32), q)
        else:
            repeat = rs.choice(np.arange(4, O), 18, replace=False)
            src = rs.randint(0, 4, 18)
            hh[repeat[:12], i] = hh[src[:12], i]          # duplicates
            hh[repeat[12:15], i] = -1 - rs.randint(0, 5, 3)
            hh[repeat[15:], i] = T + rs.randint(0, 5, 3)
            for x in np.concatenate([near, tie[:1]]):
                put(hh[rs.randint(0, 4), i], x, q)
    mask = np.ones(N, bool)
    mask[5::13] = False
    return (t(table), torch.from_numpy(hh), t(scan), torch.from_numpy(mask),
            torch.zeros(6))


# the 6x6 systems the GN-step kernel (ops/csrc/gn_small.cu) is held to its
# plain version on, in tests/test_torch_gn_small_emulated.py and on the card
GN_SMALL_CASES = ("spd_0", "spd_1", "spd_2", "gn_plane", "rank_deficient",
                  "collinear", "diagonal", "repeated_diagonal",
                  "repeated_rotated", "signed_zeros", "zero", "negative_zero",
                  "nan", "nan_diagonal")


def gn_small_case(name):
    """(AtA (6, 6), Atb (6,)) float32 numpy of case `name`: random SPD
    systems; a GN system of a ground plane and a wall (`planar_scene`, the
    fused pass's plain version); a direction no row constrains (a zero row
    and column) and two equal Jacobian columns; diagonal systems (every
    rotation takes the |apq| < 1e-30 branch), with equal eigenvalues and
    with -0 beside +0 (the stable sort's ties); equal eigenvalues of a
    rotated matrix; the all-zero system of a scan with no inliers, of +0
    and of -0 words (the damping's sum turns -0 off the diagonal into +0); a
    NaN off the diagonal and one on it (the clamp hands it on)."""
    rs = np.random.RandomState(sum(map(ord, name)))
    b = rs.randn(6).astype(np.float32)
    if name.startswith("spd_"):
        J = rs.randn(40, 6) * rs.uniform(0.01, 30.0, 6)
        return (J.T @ J).astype(np.float32), b
    if name == "gn_plane":
        from lio_slam_tpu_torch.ops import fused_corr as fc
        from lio_slam_tpu_torch.ops import voxel_grid as vg

        map_pts, scan = planar_scene(3, n_map=4096, n_scan=400)
        grid = vg.build_grid(t(map_pts), torch.ones(len(map_pts), dtype=torch.bool),
                             1.0, 4096, 24)
        pose = t(np.array([0.01, -0.02, 0.05, 0.1, -0.05, 0.02], np.float32))
        AtA, Atb = fc.fused_normal_equations_ref(
            grid, t(scan), torch.ones(len(scan), dtype=torch.bool), pose)[:2]
        return AtA.numpy(), Atb.numpy()
    if name in ("rank_deficient", "collinear"):
        J = rs.randn(40, 6).astype(np.float32)
        if name == "rank_deficient":
            J[:, 1] = 0.0
        else:
            J[:, 4] = J[:, 3]
        return (J.T @ J).astype(np.float32), b
    if name == "diagonal":
        return np.diag([40.0, 3.0, 700.0, 0.5, 12.0, 90.0]).astype(np.float32), b
    if name == "repeated_diagonal":
        return np.diag([5.0, 2.0, 5.0, 2.0, 7.0, 2.0]).astype(np.float32), b
    if name == "repeated_rotated":
        Q, _ = np.linalg.qr(rs.randn(6, 6))
        A = (Q * [1.0, 1.0, 1.0, 4.0, 4.0, 9.0]) @ Q.T
        return ((A + A.T) / 2).astype(np.float32), b
    if name == "signed_zeros":
        # a rotation's q-row sum turns a -0 on the diagonal into +0 (in torch
        # as in the kernel), so only the first stays -0 beside the +0s
        return np.diag([-0.0, 0.0, 3.0, -0.0, 0.0, 1.0]).astype(np.float32), b
    if name == "zero":
        return np.zeros((6, 6), np.float32), np.zeros(6, np.float32)
    if name == "negative_zero":
        return np.full((6, 6), -0.0, np.float32), np.full(6, -0.0, np.float32)
    if name in ("nan", "nan_diagonal"):
        J = rs.randn(40, 6)
        A = (J.T @ J).astype(np.float32)
        if name == "nan":
            A[2, 3] = A[3, 2] = np.nan
        else:
            A[5, 5] = np.nan
        return A, b
    raise ValueError(name)


def assert_same_bits(a: torch.Tensor, b: torch.Tensor):
    """`a` and `b` hold the same float32 words, but that a NaN may be any
    NaN (the card's canonical one, the CPU's with its sign and payload)."""
    assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    ia, ib = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    assert torch.equal(ia[~nan], ib[~nan]), (a, b)


# the window graphs the window-system kernel (ops/csrc/window_system.cu) is
# held to its plain version on, in tests/test_torch_window_system.py and on
# the card
WINDOW_CASES = ("chain", "loops", "half_turn", "gps", "short", "first",
                "empty", "wide", "evicted", "evicted_window")


def window_case(name):
    """(graph, count, window) of case `name`: a CPU `PoseGraph` laid out as
    the keyframe save lays it out (chain slot s joins keyframes s and s + 1,
    loop slots after the K - 1 chain slots), the odometry, prior and GPS
    information of the default preset, noisy poses, and the number of
    keyframes and the window to assemble at:
    - "chain": a pure odometry chain, the window its last 8 of 20;
    - "loops": loops with both ends in the window, one, none, a second
      factor on one window pair, and stale slots (mask off) inside it;
    - "half_turn": "loops" with the first loop's yaw measured half a turn
      off, so its error takes the Log map's near-pi form;
    - "gps": GPS factors in and out of the window, two on one keyframe;
    - "short", "first", "empty": 5, 1 and 0 keyframes in a window of 8
      (the prior in it, idle slots);
    - "wide": a window of 32 over a store of 16;
    - "evicted", "evicted_window": a full store after the ring eviction
      (`pipeline/lio._evict_oldest`): the prior moved to the old keyframe
      1 with the folded information, every index shifted down; at a window
      of 32 (the prior in it) and of 8."""
    from lio_slam_tpu_torch.graph import factors as F
    from lio_slam_tpu_torch.utils import se3

    spec = dict(chain=(24, 20, 8, [], []),
                loops=(24, 20, 8, [(13, 18), (3, 15), (2, 9), (16, 17),
                                   (19, 12)], []),
                half_turn=(24, 20, 8, [(13, 18), (3, 15), (2, 9), (16, 17),
                                       (19, 12)], []),
                gps=(24, 20, 8, [], [3, 14, 18, 14]),
                short=(24, 5, 8, [(0, 4)], [2]),
                first=(24, 1, 8, [], []),
                empty=(24, 0, 8, [], []),
                wide=(16, 14, 32, [(2, 11), (5, 13)], [3, 13]),
                evicted=(24, 24, 32, [(1, 20), (6, 22), (0, 12)], [0, 9, 21]),
                evicted_window=(24, 24, 8, [(1, 20), (6, 22), (0, 12)],
                                [0, 9, 21]))[name]
    K, count, W, loops, gps = spec
    B, G = K - 1 + 8, 6
    rs = np.random.RandomState(sum(map(ord, name.replace("half_turn",
                                                          "loops"))))
    truth = np.zeros((K, 6), np.float32)
    truth[:count, :3] = np.cumsum(rs.uniform(-0.1, 0.1, (count, 3)), 0)
    truth[:count, 3] = np.cumsum(rs.uniform(0.5, 1.0, count))
    truth[:count, 4] = np.cumsum(rs.uniform(-0.2, 0.2, count))
    noise = rs.randn(K, 6) * [0.01, 0.01, 0.01, 0.05, 0.05, 0.05]
    poses = truth + (noise * (np.arange(K) < count)[:, None]).astype(np.float32)
    bt_i, bt_j = np.zeros(B, np.int32), np.zeros(B, np.int32)
    bt_meas, bt_info = np.zeros((B, 6), np.float32), np.zeros((B, 6), np.float32)
    bt_mask = np.zeros(B, bool)
    odom = [1e6, 1e6, 1e6, 1e4, 1e4, 1e4]
    pairs = [(s, (s, s + 1), odom) for s in range(count - 1)]
    pairs += [(K - 1 + q, ij, [1e3, 1e3, 1e3, 1e2, 1e2, 1e2])
              for q, ij in enumerate(loops)]
    for s, (i, j), info in pairs:
        meas = se3.pose6_between(t(truth[i]), t(truth[j])).numpy()
        bt_i[s], bt_j[s] = i, j
        bt_meas[s] = meas + rs.randn(6).astype(np.float32) * 1e-3
        bt_info[s] = info
        bt_mask[s] = True
    if name == "half_turn":         # the residual at these poses: Rz(pi - 2e-4)
        turn = t(np.array([0, 0, np.pi - 2e-4, 0, 0, 0], np.float32))
        bt_meas[K - 1] = se3.pose6_compose(
            se3.pose6_between(t(poses[13]), t(poses[18])), turn).numpy()
    if name in ("loops", "half_turn"):      # stale slots inside the window
        s = K - 1 + len(loops)
        bt_i[s:s + 2], bt_j[s:s + 2] = (14, 15), (15, 16)
        bt_info[s:s + 2] = odom
    gps_i, gps_meas = np.zeros(G, np.int32), np.zeros((G, 3), np.float32)
    gps_info, gps_mask = np.zeros((G, 3), np.float32), np.zeros(G, bool)
    for s, i in enumerate(gps):
        gps_i[s] = i
        gps_meas[s] = truth[i, 3:] + rs.randn(3) * 0.1
        gps_info[s] = [1.0, 1.0, 0.5]
        gps_mask[s] = True
    g = F.PoseGraph(
        poses=t(poses), pose_mask=torch.from_numpy(np.arange(K) < count),
        prior_pose=t(truth[0]),
        prior_info=t(np.array([100, 100, 0.1, 1e-8, 1e-8, 1e-8], np.float32)),
        bt_i=torch.from_numpy(bt_i), bt_j=torch.from_numpy(bt_j),
        bt_meas=t(bt_meas), bt_info=t(bt_info),
        bt_mask=torch.from_numpy(bt_mask), gps_i=torch.from_numpy(gps_i),
        gps_meas=t(gps_meas), gps_info=t(gps_info),
        gps_mask=torch.from_numpy(gps_mask))
    if name.startswith("evicted"):
        from lio_slam_tpu_torch.config import Config, StaticConfig
        from lio_slam_tpu_torch.pipeline import lio

        cfg = Config(static=StaticConfig(
            max_raw_points=64, max_scan_points=64, max_map_points=256,
            max_keyframes=K, max_keyframe_points=64, max_loop_queue=2,
            max_gps_queue=2, window_size=W, max_imu_window=16))
        state = lio.init_state(cfg)
        state = state._replace(graph=g, store=state.store._replace(
            count=torch.tensor(count, dtype=torch.int32)))
        g = lio._evict_oldest(state).graph
        count -= 1
    return g, torch.tensor(count, dtype=torch.int32), W


# H blockwise, relative to the block's largest entry: each version is within
# 1.0e-5 of the float64 system on these graphs (a loop's Jacobian rows carry
# lever arms of about 10 m, and float32 rounds their cancelling products at
# 1e-6 of the block's rotation entries); measured gap 1.8e-5
WINDOW_H_RTOL = 5e-5
# b blockwise, relative to the block's largest entry: the residuals are Log
# maps of near-identity transforms, 1e-3 of the O(1) entries they are
# differences of; each version is within 3e-6 of float64, gap 1.8e-6
WINDOW_B_RTOL = 2e-5
# poses after the two GN iterations.  With the prior outside the window the
# window hangs on stiff odometry to a held pose, and the versions part by
# float32 steps of poses a few metres out (gap 1.9e-6 m); with the prior
# inside, its 1e-8 translation information leaves the system near-singular
# (condition ~1e12 before equilibration), as in
# test_torch_graph.py::test_solve_window_compact_matches (gap 3.0e-4)
WINDOW_POSE_ATOL = 2e-5
WINDOW_POSE_ATOL_PRIOR = 1e-3
# "half_turn": a loop's residual of half a turn pulls the window hard
# against its odometry through the near-pi Log, whose float32 form both
# versions round alike (gap 1.3e-7 of a block) but apart from float64 (by
# 1.2e-4 of a block, over WINDOW_H_RTOL): the kernel is held to the plain
# version alone there, its poses to 2e-4 m (gap 2.4e-5)
WINDOW_POSE_ATOL_HALF_TURN = 2e-4


def window_pose_atol(case, count, W) -> float:
    """The bound on the window solve's poses, kernel against plain."""
    if int(count) <= W:
        return WINDOW_POSE_ATOL_PRIOR
    return WINDOW_POSE_ATOL_HALF_TURN if case == "half_turn" \
        else WINDOW_POSE_ATOL


def window_truth(case, graph, count, W):
    """The float64 system to hold both versions to, or None ("half_turn")."""
    return None if case == "half_turn" else window_float64_system(
        graph, count, W)


def window_blocks(H, W):
    """(W, W, 6, 6) blocks of a (6W, 6W) window system."""
    return H.reshape(W, 6, W, 6).permute(0, 2, 1, 3)


def assert_window_close(got, ref, W, truth=None):
    """H and b of `got` against `ref` block by block; the zero blocks
    exactly; with `truth` (the float64 system) both within the bounds of
    it too."""
    (Hg, bg), (Hr, br) = got, ref
    scale = window_blocks(Hr, W).abs().amax((2, 3))
    assert torch.equal(window_blocks(Hg, W).abs().amax((2, 3)) == 0,
                       scale == 0)
    gap = window_blocks(Hg - Hr, W).abs().amax((2, 3))
    assert (gap <= WINDOW_H_RTOL * scale).all(), \
        float((gap / scale.clamp(min=1e-30)).max())
    bscale = br.reshape(W, 6).abs().amax(1)
    bgap = (bg - br).reshape(W, 6).abs().amax(1)
    assert (bgap <= WINDOW_B_RTOL * bscale).all()
    if truth is not None:
        for H, b in (got, ref):
            assert_window_close((H.double(), b.double()), truth, W)


def window_float64_system(graph, count, W):
    """The plain version's window system of `graph` in float64."""
    from lio_slam_tpu_torch.graph import factors as F
    from lio_slam_tpu_torch.graph import solver

    g = F.PoseGraph(*(x.double() if x.is_floating_point() else x
                      for x in graph))
    return solver.assemble_window_plain(g, count, W)
