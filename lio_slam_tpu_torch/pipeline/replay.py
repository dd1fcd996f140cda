"""Batch replay of a stacked scan sequence through the whole pipeline (port
of `lio_slam_tpu/pipeline/replay.py`).

Per scan, with no oracle inputs (the initial guess is the IMU front-end's
prediction, as in a live mission):

    deskew rotation table + per-point deskew + range/crop filter
      (imageProjection.cpp:359-418, 502-615)
    -> front-end predict over the IMU window  (imuHandler :518-613)
    -> per-scan LIO mapping step              (laserCloudInfoHandler :432-506)
    -> loop detector every `loop_every` scans, then the full-graph
       correction when a factor landed        (loopClosureThread, correctPoses)
    -> front-end correction                   (odometryHandler :271-516)
    -> TransformFusion                        (:107-129)

The prep is the replay's own, not the Runner's: deskew sees `pmask &
have_imu`, the front-end correction takes the samples up to the scan stamp
(`rel_t <= 1e-6`), the positional deskew increment is applied only with
`cfg.lidar.deskew_position`, and the guess is the last pose of
`predict_rate`.

Two forms:

- `HostDrivenReplay`: the stages called scan by scan, as the JAX class of
  that name dispatches its programs.  It reads the device where the
  mapping step branches on the host: once a GN iteration, at the
  keyframe gate and at the full correction's flag.
- The device-resident scan programs, the counterparts of the JAX package's
  `lax.scan` programs: `make_pipeline_replay`, `make_pipeline_replay_carry`
  and `ChunkedReplay`.  Their per-scan step is sync-free: the GN loop runs
  all its passes with converged ones frozen on the device, and the
  keyframe gate and the eviction are device selects, as the front-end's
  two checks are on every path (`lax.while_loop` and `lax.cond` in the
  reference).  They run every config the JAX scan programs run: the
  incremental map and the rebuild-mode map (the local map assembled from
  the nearby keyframes each scan and registered through
  `register(resident=True)`, its grid built inside the step, or the
  brute-force k-NN), and `use_corner_features=True` on the surface path,
  as the JAX step takes it where a replay feeds no corner cloud.  The GPS
  factor is left out: neither package's replay feeds a GPS fix.  On
  the card each scan runs as two captured CUDA graphs
  (`torch.cuda.CUDAGraph`, the counterpart of `jax.jit`), (a)
  prep+predict+mapping step and (b) front-end correction + TransformFusion
  over the rate train, on static buffers that the graphs update in place;
  nothing is read back inside a scan or between the scans of a chunk.  The
  kernel launches a graph holds count in `fused_corr.KERNEL_LAUNCHES`,
  `gn_small.KERNEL_LAUNCHES` and `window_system.KERNEL_LAUNCHES` at each
  replay.  Capture happens once per
  program (at `capture` or the first call); a failed capture raises, and
  there is no fallback to the host-driven loop.  On the CPU (`device="cpu"`, the tests) the same
  resident step runs eagerly.

The loop detector and the full correction run eagerly at the cadence
scans, the only host reads of a resident replay (their work is sized on
the host: `loop_closure.py` reads its candidates, `graph/sparse.py` its
factor counts).  Stated departure: the JAX monolith calls `full_correct`
(a `lax.cond` on `needs_full_solve`) after every scan; the port calls it
at the cadence scans only, right after the detector, as the JAX
`ChunkedReplay` and both packages' `HostDrivenReplay` do.  In a replay
the flag rises only at a keyframe save that consumes a loop the detector
queued, so where no loop is accepted the two agree exactly; a loop
consumed between cadence scans is solved at the next cadence scan here,
and at the scan that consumed it in the JAX monolith.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lio_slam_tpu_torch.config import Config
from lio_slam_tpu_torch.ops import deskew as deskew_mod
from lio_slam_tpu_torch.pipeline import imu_frontend as fe
from lio_slam_tpu_torch.pipeline import lio
from lio_slam_tpu_torch.pipeline import live
from lio_slam_tpu_torch.pipeline import loop_closure
from lio_slam_tpu_torch.utils import pointcloud as pc
from lio_slam_tpu_torch.utils import profiling
from lio_slam_tpu_torch.utils import se3


class ReplayBatch(NamedTuple):
    """Per-scan stacked sensor inputs (leading axis = scans)."""

    xyz: torch.Tensor     # (N, P, 3) raw padded scans
    ptime: torch.Tensor   # (N, P) per-point time since the scan start
    pmask: torch.Tensor   # (N, P) bool
    ring: torch.Tensor    # (N, P) int32
    acc: torch.Tensor     # (N, W, 3) IMU window (lidar frame)
    gyr: torch.Tensor     # (N, W, 3)
    dts: torch.Tensor     # (N, W)
    rel_t: torch.Tensor   # (N, W) sample time since the scan stamp
    imask: torch.Tensor   # (N, W) bool
    stamp: torch.Tensor   # (N,)


class ReplayOut(NamedTuple):
    poses: torch.Tensor       # (N, 6) mapping odometry
    iters: torch.Tensor       # (N,) GN iterations a scan
    fused_last: torch.Tensor  # (N, 6) TransformFusion output at window end
    degenerate: torch.Tensor  # (N,) bool


def _device(device) -> torch.device:
    """`device` as a torch.device, refused where it names a card that
    torch does not find."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the replay (device={str(device)!r}) needs a CUDA device and "
            'torch finds none; pass device="cpu" to run on the CPU')
    return device


def stage(batch: ReplayBatch, device) -> ReplayBatch:
    """The batch's arrays as tensors on `device` (numpy arrays or tensors)."""
    return ReplayBatch(*(torch.as_tensor(a).to(device) for a in batch))


def prep_predict(cfg: Config, predict_rate, fes: fe.ImuFrontendState,
                 s: ReplayBatch):
    """Deskew, filter and the front-end's prediction for one scan `s`:
    (ScanInput, the correction's IMU mask, the IMU-rate pose train)."""
    lid = cfg.lidar
    dev = s.xyz.device
    have_imu = torch.any(s.imask)
    table = deskew_mod.build_rotation_table(s.gyr, s.rel_t, s.imask)
    imask_corr = s.imask & (s.rel_t <= live.CORRECTION_MARGIN)
    rate_poses = predict_rate(fes, s.acc, s.gyr, s.dts, imask_corr)
    pos_inc, dur = None, None
    if lid.deskew_position:
        # the sweep's increment from the IMU-rate pose train: the
        # displacement over the window in the window-start body frame
        R_first = se3.pose6_to_Rt(rate_poses[0])[0]
        inc = R_first.T @ (rate_poses[-1][3:] - rate_poses[0][3:])
        pos_inc = torch.where(fes.initialized & have_imu, inc,
                              torch.zeros_like(inc))
        dur = lid.sweep_time
    desk = deskew_mod.deskew(s.xyz, s.ptime, s.pmask & have_imu, table,
                             pos_increment=pos_inc, scan_duration=dur)
    cloud = pc.filter_points(pc.Cloud(xyz=desk, mask=s.pmask),
                             lid.lidar_min_range, lid.lidar_max_range,
                             lid.crop_box_min, lid.crop_box_max)
    if lid.point_filter_num > 1 or lid.downsample_rate > 1:
        cloud = pc.decimate(cloud, lid.point_filter_num, ring=s.ring,
                            downsample_rate=lid.downsample_rate)
    f32 = dict(dtype=torch.float32, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    sin = lio.ScanInput(
        cloud=cloud, stamp=s.stamp.to(torch.float32),
        init_guess=rate_poses[-1], guess_valid=fes.initialized & have_imu,
        imu_rpy=se3.matrix_to_rpy(fes.nav.R),
        imu_available=have_imu & fes.initialized,
        gps_pos=torch.zeros(3, **f32), gps_info=torch.zeros(3, **f32),
        gps_valid=no)
    return sin, imask_corr, rate_poses


class HostDrivenReplay:
    """The pipeline replayed scan by scan: prep+predict, the mapping step,
    the detector and full correction at cadence, correct+fuse.

        hd = HostDrivenReplay(cfg, loop_every=10)
        scans = hd.split(batch)                 # per-scan inputs on the device
        state, fes = hd.init()
        state, fes, outs = hd.run(state, fes, scans)
    """

    def __init__(self, cfg: Config, loop_every: int = 10, device="cuda"):
        """`device`: where the replay runs; the card by default, and never
        the CPU unless asked (`device="cpu"`)."""
        self.device = _device(device)
        self.cfg = cfg
        self.loop_every = int(loop_every)
        self.correct, self.predict_rate, self.transform_fusion = \
            fe.make_frontend(cfg.imu)
        self.step = lio.make_lio_step(cfg, device=self.device)
        self.detector = loop_closure.make_loop_detector(cfg)
        self.full_correct = lio.make_full_correction(cfg, device=self.device)

    def init(self):
        return (lio.init_state(self.cfg, device=self.device),
                fe.init_state(device=self.device))

    def split(self, batch: ReplayBatch) -> list:
        """Per-scan `ReplayBatch` slices on the device, made before the
        timed loop."""
        n = len(batch.stamp)
        return [stage(ReplayBatch(*(a[i] for a in batch)), self.device)
                for i in range(n)]

    def _prep_predict(self, fes: fe.ImuFrontendState, s: ReplayBatch):
        return prep_predict(self.cfg, self.predict_rate, fes, s)

    def run(self, state: lio.LioState, imu_state: fe.ImuFrontendState,
            scans: list):
        last_pose = torch.zeros(6, dtype=torch.float32, device=self.device)
        poses, iters, fused_out, degen = [], [], [], []
        for i, s in enumerate(scans):
            sin, imask_corr, rate_poses = self._prep_predict(imu_state, s)
            state, out = self.step(state, sin)
            if self.loop_every > 0 and (i + 1) % self.loop_every == 0:
                state, _ = self.detector(state)
                state = self.full_correct(state)
            cur_pose = state.pose.clone()
            imu_state = self.correct(imu_state, s.acc, s.gyr, s.dts,
                                     imask_corr, cur_pose, out.degenerate)
            fused = self.transform_fusion(last_pose, rate_poses[0],
                                          rate_poses[-1])
            last_pose = cur_pose
            poses.append(cur_pose)
            iters.append(out.registration_iters)
            fused_out.append(fused)
            degen.append(out.degenerate)
        outs = ReplayOut(
            poses=torch.stack(poses),
            iters=torch.tensor(iters, dtype=torch.int32, device=self.device),
            fused_last=torch.stack(fused_out), degenerate=torch.stack(degen))
        return state, imu_state, outs


# ---------------------------------------------------------------------------
# the device-resident scan programs
# ---------------------------------------------------------------------------

def _clone(tree):
    """A copy of every tensor of a (nested) NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        leaves = [_clone(x) for x in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(leaves)
    return tree


def _copy_into(dst, src):
    """Write every tensor of `src` into its place in `dst`, in place (a
    device-to-device copy each; a leaf that already is its place is left)."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
        return
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_into(d, s)


class _ScanMapped(NamedTuple):
    """What stage (a) hands stage (b) and the outputs: device tensors."""
    degenerate: torch.Tensor    # () bool
    iters: torch.Tensor         # () int32
    imask_corr: torch.Tensor    # (W,) bool
    rate_poses: torch.Tensor    # (W, 6)


class _ScanProgram:
    """The per-scan program of the resident replays, on static buffers:
    `state`, `fes`, `last_pose` carry across scans, `scan` holds the
    current scan's inputs.  Stage (a) runs prep+predict and the resident
    mapping step and writes the new state into `state`; stage (b) runs the
    resident front-end correction with the mapping pose and TransformFusion
    over the rate train, and writes `fes`, `last_pose` and the scan's
    outputs.  On the card each stage is a CUDA graph captured once; on the
    CPU it runs eagerly.

    Spans (`utils/profiling.TRACER`, when on): `replay.chunk` around
    `run`; `replay.scan` from before a scan's input copies (`map_scan`) to
    after its output copies (`finish_scan`), with device marks at both
    ends on the card, its scan id the scan's row of the batch;
    `replay.capture` around the capture."""

    def __init__(self, cfg: Config, device):
        self.cfg = cfg
        self.device = device
        self.step = lio.make_lio_step(cfg, device=device, resident=True)
        self.correct, self.predict_rate, self.transform_fusion = \
            fe.make_frontend(cfg.imu)
        self.state = self.fes = self.last_pose = self.scan = None
        self.graphs = None
        self.graph_launches = (0, 0)     # fused_corr nodes of (a), (b)
        # gn_small nodes of (a), (b): (launches, of them with the eigensolve)
        self.gn_graph_launches = ((0, 0), (0, 0))
        self.ws_graph_launches = (0, 0)  # window_system nodes of (a), (b)
        self.capture_seconds = None
        self._scan_span = None           # the open `replay.scan`

    # -- the two stages, on the static buffers --
    def _stage_a(self) -> _ScanMapped:
        sin, imask_corr, rate_poses = prep_predict(
            self.cfg, self.predict_rate, self.fes, self.scan)
        state, out = self.step(self.state, sin)
        _copy_into(self.state, state)
        return _ScanMapped(degenerate=out.degenerate,
                           iters=out.registration_iters,
                           imask_corr=imask_corr, rate_poses=rate_poses)

    def _stage_b(self, a: _ScanMapped):
        """(pose, TransformFusion output at the window's end)."""
        pose = self.state.pose.clone()
        s = self.scan
        fes = self.correct(self.fes, s.acc, s.gyr, s.dts, a.imask_corr, pose,
                           a.degenerate)
        fused = self.transform_fusion(self.last_pose, a.rate_poses[0],
                                      a.rate_poses)[-1]
        _copy_into(self.fes, fes)
        self.last_pose.copy_(pose)
        return pose, fused

    # -- buffers and capture --
    def _bind(self, state, fes, batch: ReplayBatch):
        """Allocate the static buffers once, shaped like these inputs."""
        if self.state is None:
            self.state, self.fes = _clone(state), _clone(fes)
            self.last_pose = torch.zeros(6, dtype=torch.float32,
                                         device=self.device)
            self.scan = ReplayBatch(*(a[0].clone() for a in batch))

    def load(self, state, fes, last_pose, batch: ReplayBatch):
        """Copy a carried state into the static buffers (capturing first
        where that has not happened yet)."""
        self.capture(state, fes, batch)
        _copy_into(self.state, state)
        _copy_into(self.fes, fes)
        self.last_pose.copy_(last_pose)

    def capture(self, state, fes, batch: ReplayBatch):
        """Bind the buffers and, on the card, capture both stages: warm-up
        on a side stream over copies of the buffers (builds the kernel
        library, creates the solver handles, grants the kernel its shared
        memory and makes its scratch on that stream), then one capture of
        each stage on the same stream.  A failure raises."""
        self._bind(state, fes, batch)
        if self.device.type != "cuda" or self.graphs is not None:
            return
        import time

        t0 = time.perf_counter()
        with profiling.TRACER.span("replay.capture"):
            self._capture(batch)
        self.capture_seconds = time.perf_counter() - t0

    def _capture(self, batch: ReplayBatch):
        from lio_slam_tpu_torch.ops import fused_corr, gn_small, window_system

        def gn_captured():
            return (gn_small.CAPTURED_LAUNCHES,
                    gn_small.CAPTURED_EIGH_LAUNCHES)

        _copy_into(self.scan, ReplayBatch(*(a[0] for a in batch)))
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        held = (self.state, self.fes, self.last_pose)
        with torch.cuda.stream(side):
            fused_corr.prepare_stream(self.device)
            for _ in range(2):
                self.state, self.fes, self.last_pose = _clone(held)
                self._stage_b(self._stage_a())
        self.state, self.fes, self.last_pose = held
        torch.cuda.synchronize(self.device)
        graph_a, graph_b = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        n0, g0 = fused_corr.CAPTURED_LAUNCHES, gn_captured()
        w0 = window_system.CAPTURED_LAUNCHES
        try:
            with torch.cuda.graph(graph_a, stream=side):
                mapped = self._stage_a()
            n_a, g_a = fused_corr.CAPTURED_LAUNCHES - n0, gn_captured()
            w_a = window_system.CAPTURED_LAUNCHES - w0
            with torch.cuda.graph(graph_b, pool=graph_a.pool(), stream=side):
                pose, fused = self._stage_b(mapped)
        except Exception as exc:
            raise RuntimeError("capturing the resident replay's per-scan "
                               f"step as a CUDA graph failed: {exc}") from exc
        torch.cuda.synchronize(self.device)
        self.graph_launches = (n_a, fused_corr.CAPTURED_LAUNCHES - n0 - n_a)
        g_b = gn_captured()
        self.gn_graph_launches = (tuple(a - b for a, b in zip(g_a, g0)),
                                  tuple(a - b for a, b in zip(g_b, g_a)))
        self.ws_graph_launches = (w_a,
                                  window_system.CAPTURED_LAUNCHES - w0 - w_a)
        self.graphs = (graph_a, graph_b)
        self._a, self._b = mapped, (pose, fused)

    # -- one scan --
    def map_scan(self, batch: ReplayBatch, i: int) -> _ScanMapped:
        """Stage (a) of scan `i` of a staged batch."""
        self._scan_span = profiling.TRACER.begin(
            "replay.scan", device=self.device.type == "cuda", scan=i)
        _copy_into(self.scan, ReplayBatch(*(a[i] for a in batch)))
        if self.graphs is None:
            return self._stage_a()
        self._replay(0)
        return self._a

    def _replay(self, k: int):
        """Replay graph `k`; its kernel launches count here."""
        from lio_slam_tpu_torch.ops import fused_corr, gn_small, window_system

        self.graphs[k].replay()
        fused_corr.KERNEL_LAUNCHES += self.graph_launches[k]
        gn_small.KERNEL_LAUNCHES += self.gn_graph_launches[k][0]
        gn_small.EIGH_LAUNCHES += self.gn_graph_launches[k][1]
        window_system.KERNEL_LAUNCHES += self.ws_graph_launches[k]

    def finish_scan(self, mapped: _ScanMapped, outs: ReplayOut, i: int):
        """Stage (b) of the scan, its outputs written at row `i` of
        `outs`."""
        if self.graphs is None:
            pose, fused = self._stage_b(mapped)
        else:
            self._replay(1)
            pose, fused = self._b
        outs.poses[i].copy_(pose)
        outs.fused_last[i].copy_(fused)
        outs.iters[i].copy_(mapped.iters)
        outs.degenerate[i].copy_(mapped.degenerate)
        profiling.TRACER.end(self._scan_span)
        self._scan_span = None

    def empty_outputs(self, n: int) -> ReplayOut:
        f32 = dict(dtype=torch.float32, device=self.device)
        return ReplayOut(
            poses=torch.empty((n, 6), **f32),
            iters=torch.empty(n, dtype=torch.int32, device=self.device),
            fused_last=torch.empty((n, 6), **f32),
            degenerate=torch.empty(n, dtype=torch.bool, device=self.device))

    def run(self, batch: ReplayBatch, outs: ReplayOut, first: int = 0,
            cadence=None):
        """Scans 0..n-1 of `batch` into rows first.. of `outs`;
        `cadence(i)`, where given, runs between the stages of scan `i`
        (the loop detector and the full correction on `self.state`)."""
        with profiling.TRACER.span("replay.chunk"):
            for i in range(len(batch.stamp)):
                mapped = self.map_scan(batch, i)
                if cadence is not None:
                    cadence(first + i)
                self.finish_scan(mapped, outs, first + i)


class _ResidentReplay:
    """What the resident replays share: the per-scan program, the detector
    and the full correction of the cadence scans, the empty state.
    `capture_seconds` is what the program's capture took (None on the CPU
    and before it)."""

    def __init__(self, cfg: Config, loop_every: int = 10, device="cuda"):
        self.device = _device(device)
        self.cfg = cfg
        self.loop_every = int(loop_every)
        self.program = _ScanProgram(cfg, self.device)
        self.detector = loop_closure.make_loop_detector(cfg)
        self.full_correct = lio.make_full_correction(cfg, device=self.device)

    @property
    def capture_seconds(self):
        return self.program.capture_seconds

    def init(self):
        return (lio.init_state(self.cfg, device=self.device),
                fe.init_state(device=self.device))

    def _correct(self):
        """The detector and the full correction on the program's state."""
        st, _ = self.detector(self.program.state)
        _copy_into(self.program.state, self.full_correct(st))


class PipelineReplay(_ResidentReplay):
    """`make_pipeline_replay`'s program: `replay(state, imu_state, batch,
    last_pose0=None) -> (state, imu_state, ReplayOut)`, the whole batch
    scan by scan on the device, the detector and the full correction at
    the cadence scans (`idx % loop_every == loop_every - 1`) between the
    mapping step and the front-end correction, as the JAX monolith orders
    them.  `stage(batch)` puts a numpy batch on the device and
    `capture(state, imu_state, batch)` captures ahead of the first call."""

    def stage(self, batch: ReplayBatch) -> ReplayBatch:
        return stage(batch, self.device)

    def capture(self, state, imu_state, batch: ReplayBatch):
        self.program.capture(state, imu_state, self.stage(batch))

    def _cadence(self, idx: int):
        L = self.loop_every
        if L > 0 and idx % L == L - 1:
            self._correct()

    def __call__(self, state, imu_state, batch: ReplayBatch, last_pose0=None):
        batch = self.stage(batch)
        if last_pose0 is None:
            last_pose0 = torch.zeros(6, dtype=torch.float32,
                                     device=self.device)
        prog = self.program
        prog.load(state, imu_state, last_pose0, batch)
        outs = prog.empty_outputs(len(batch.stamp))
        prog.run(batch, outs, cadence=self._cadence)
        return _clone(prog.state), _clone(prog.fes), outs


def make_pipeline_replay(cfg: Config, loop_every: int = 10, device="cuda"):
    """replay(lio_state, imu_state, batch, last_pose0=None) -> (lio_state,
    imu_state, ReplayOut): the whole pipeline scan by scan on the device
    (a `PipelineReplay`).  Raises without a card unless `device="cpu"`."""
    return PipelineReplay(cfg, loop_every=loop_every, device=device)


def make_pipeline_replay_carry(cfg: Config, device="cuda"):
    """chunk(state, imu_state, last_pose, batch) -> (state, imu_state,
    state.pose, ReplayOut): the per-scan program without the detector and
    the correction, the TransformFusion carry threaded through, for
    chunked callers (a `PipelineReplay` with `loop_every=0`)."""
    inner = PipelineReplay(cfg, loop_every=0, device=device)

    def chunk(state, imu_state, last_pose, batch):
        st, fes, outs = inner(state, imu_state, batch, last_pose)
        return st, fes, st.pose, outs

    chunk.replay = inner      # its `capture` and `capture_seconds`
    return chunk


class ChunkedReplay(_ResidentReplay):
    """Whole-pipeline replay in cadence-sized chunks: `loop_every` scans of
    the resident per-scan program, then the loop detector and the full
    correction (eager, the only host reads), chunk after chunk.

        cr = ChunkedReplay(cfg, loop_every=10)
        chunks = cr.split(batch)                 # chunk batches on the device
        state, fes = cr.init()
        state, fes, outs = cr.run(state, fes, chunks)
    """

    def split(self, batch: ReplayBatch) -> list:
        n = len(batch.stamp)
        L = self.loop_every
        if L <= 0 or n % L:
            raise ValueError(f"n_scans {n} must divide by loop_every {L}")
        staged = stage(batch, self.device)
        return [ReplayBatch(*(a[i * L:(i + 1) * L] for a in staged))
                for i in range(n // L)]

    def capture(self, state, imu_state, chunk: ReplayBatch):
        self.program.capture(state, imu_state, chunk)

    def run(self, state, imu_state, chunks: list):
        prog = self.program
        prog.load(state, imu_state,
                  torch.zeros(6, dtype=torch.float32, device=self.device),
                  chunks[0])
        outs = prog.empty_outputs(sum(len(c.stamp) for c in chunks))
        first = 0
        for cb in chunks:
            prog.run(cb, outs, first=first)
            first += len(cb.stamp)
            self._correct()
        return _clone(prog.state), _clone(prog.fes), outs
