"""Batch replay of a stacked scan sequence through the whole pipeline (port
of `HostDrivenReplay` in `lio_slam_tpu/pipeline/replay.py`).

Per scan, with no oracle inputs (the initial guess is the IMU front-end's
prediction, as in a live mission):

    deskew rotation table + per-point deskew + range/crop filter
      (imageProjection.cpp:359-418, 502-615)
    -> front-end predict over the IMU window  (imuHandler :518-613)
    -> per-scan LIO mapping step              (laserCloudInfoHandler :432-506)
    -> loop detector every `loop_every` scans, then the full-graph
       correction when a factor landed        (loopClosureThread, correctPoses)
    -> front-end correction                   (odometryHandler :271-516)
    -> TransformFusion at the window's end    (:107-129)

The prep is the replay's own, not the Runner's: deskew sees `pmask &
have_imu`, the front-end correction takes the samples up to the scan stamp
(`rel_t <= 1e-6`), the positional deskew increment is applied only with
`cfg.lidar.deskew_position`, and the guess is the last pose of
`predict_rate`.  The per-scan outputs stay on the device and are stacked
at the end of `run`.  Unlike the JAX version, whose stages are compiled
programs dispatched without a fetch, the loop reads the device where the
mapping step and the correction branch on the host: once a GN iteration,
at the keyframe gate, at the front-end's initialized and failure checks,
and at the full correction's flag.  The JAX package's whole-pipeline
`lax.scan` programs (`make_pipeline_replay`, `ChunkedReplay`) exist to
work around XLA compiles and are not ported.
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
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"HostDrivenReplay(device={str(device)!r}) needs a CUDA device "
                'and torch finds none; pass device="cpu" to run on the CPU')
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
        return [ReplayBatch(*(torch.as_tensor(a[i]).to(self.device)
                              for a in batch)) for i in range(n)]

    def _prep_predict(self, fes: fe.ImuFrontendState, s: ReplayBatch):
        lid = self.cfg.lidar
        have_imu = torch.any(s.imask)
        table = deskew_mod.build_rotation_table(s.gyr, s.rel_t, s.imask)
        imask_corr = s.imask & (s.rel_t <= live.CORRECTION_MARGIN)
        rate_poses = self.predict_rate(fes, s.acc, s.gyr, s.dts, imask_corr)
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
        f32 = dict(dtype=torch.float32, device=self.device)
        no = torch.zeros((), dtype=torch.bool, device=self.device)
        sin = lio.ScanInput(
            cloud=cloud, stamp=s.stamp.to(torch.float32),
            init_guess=rate_poses[-1], guess_valid=fes.initialized & have_imu,
            imu_rpy=se3.matrix_to_rpy(fes.nav.R),
            imu_available=have_imu & fes.initialized,
            gps_pos=torch.zeros(3, **f32), gps_info=torch.zeros(3, **f32),
            gps_valid=no)
        return sin, imask_corr, rate_poses

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
