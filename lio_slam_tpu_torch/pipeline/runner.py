"""Host-side mission runner (port of `lio_slam_tpu/pipeline/runner.py`).

`Runner(cfg)` drives one scan at a time through the port's main path, on
the CUDA device unless the caller passes `device="cpu"`:

    IMU prediction (predict_rate, TransformFusion) -> scan prep (deskew,
    range/crop filter, LOAM corner extraction when
    `use_corner_features`, decimation) -> GPS intake (FSM, datum, gates) ->
    mapping step (downsample, GN registration through the fused kernel,
    keyframe save with loop and GPS factors) -> full-graph correction and
    map rebuild when a factor landed -> IMU front-end correction -> every
    `loop_every` scans the loop detector (radius search and Scan Context,
    each verified by a registration against a submap grid), then the
    keyframe archive's retrieval over evicted keyframes
    (`pipeline/archive.py`, verified the same way)

What the host needs of a scan is queued and copied off the device
asynchronously (`fetch_every`, `drain`); the archive, the mission log and
the trajectory are fed from that queue, and so is the output bag
(`record_bag`: odometry, gpsdata and sensor_fusion_output records).
Checkpoints (`save_checkpoint`, `auto_checkpoint`, `Runner.resume`) use the
JAX package's format.

With `mesh` (a `parallel/mesh.make_mesh` DeviceMesh) the mission runs
sharded (`parallel/mission.py`): one process per device, each with a
`Runner` of its own fed the same scans, holding its slice of the map grid
and of the keyframe clouds.  Launch it as

    torchrun --nproc-per-node=D my_mission.py
    # in my_mission.py, on every rank:
    mesh = make_mesh(device_type="cuda")   # NCCL from torchrun's environment
    runner = Runner(cfg, device=f"cuda:{local_rank}", mesh=mesh)
    for scan, imu in feed: runner.process_scan(scan, imu=imu)

Every rank must make the same calls (checkpoints and map products gather
the sharded leaves, a collective); files (mission log, output bag,
checkpoint, save_map) are written by rank 0 only.

CLI (a ROS1 bag through `io/bag_replay.py`, or the synthetic mission):
    python -m lio_slam_tpu_torch.pipeline.runner --bag X.bag \
        [--lidar-topic T] [--imu-topic T] [--gps-topic T] [--sensor S] \
        [--record-bag out.bag] [--device cpu] [...]
    python -m lio_slam_tpu_torch.pipeline.runner --synthetic --scans 20 \
        --points 8192 [--loop-every 10] [--device cpu] [--mission-log F] \
        [--auto-checkpoint F --checkpoint-every N] [--resume-from F] \
        [--save-map DIR] [--record-bag out.bag] [--report-timing]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from lio_slam_tpu_torch.config import Config, get_config
from lio_slam_tpu_torch.io import formats
from lio_slam_tpu_torch.io import rosbag as rb
from lio_slam_tpu_torch.ops import deskew as deskew_mod
from lio_slam_tpu_torch.ops import features as feat_mod
from lio_slam_tpu_torch.pipeline import archive as arch_mod
from lio_slam_tpu_torch.pipeline import checkpoint
from lio_slam_tpu_torch.pipeline import gps_fusion as gf
from lio_slam_tpu_torch.pipeline import imu_frontend as fe
from lio_slam_tpu_torch.pipeline import live
from lio_slam_tpu_torch.pipeline import lio
from lio_slam_tpu_torch.pipeline import loop_closure
from lio_slam_tpu_torch.pipeline import outputs
from lio_slam_tpu_torch.utils import pointcloud as pc
from lio_slam_tpu_torch.utils import profiling
from lio_slam_tpu_torch.utils import se3


@dataclass
class ScanResult:
    pose: np.ndarray           # (6,) map-frame odometry
    incremental: np.ndarray    # (6,)
    degenerate: bool
    is_keyframe: bool
    num_inliers: int
    positioning_mode: int
    imu_rate_poses: Optional[np.ndarray] = None    # (T, 6)
    fused_rate_poses: Optional[np.ndarray] = None  # (T, 6) TransformFusion
    registration_iters: int = 0                    # GN iterations this scan


def extract_corners(desk: torch.Tensor, mask: torch.Tensor,
                    ring: torch.Tensor, cfg: Config) -> pc.Cloud:
    """The scan's LOAM corners: the range image from ring and azimuth, the
    edge features over it, and the first `max_corner_points` edge pixels in
    pixel order (a stable sort puts the edges first), as a cloud of the
    deskewed points."""
    lid, r = cfg.lidar, cfg.registration
    ranges, vimg, idx_img = feat_mod.project_range_image(
        desk, mask, ring, lid.n_scan, lid.horizon_scan)
    f = feat_mod.extract_features(ranges, vimg, edge_threshold=r.edge_threshold,
                                  surf_threshold=r.surf_threshold)
    flat_edge = f.edge_mask.reshape(-1)
    flat_idx = idx_img.reshape(-1)
    take = torch.argsort((~flat_edge).to(torch.int32),
                         stable=True)[:cfg.static.max_corner_points]
    c_idx = flat_idx[take]
    c_ok = flat_edge[take] & (c_idx >= 0)
    return pc.Cloud(xyz=desk[torch.clamp(c_idx, min=0).to(torch.int64)],
                    mask=c_ok)


class Runner:
    def __init__(self, cfg: Optional[Config] = None, device="cuda",
                 loop_every: int = 10,
                 record_bag: Optional[str] = None,
                 mission_log: Optional[str] = None, fetch_every: int = 1,
                 auto_checkpoint: Optional[str] = None,
                 checkpoint_every: int = 50, mesh=None):
        """`device`: where every tensor of the mission lives; the card by
        default, and never the CPU unless asked (`device="cpu"`).
        `loop_every`: the loop detector runs every that many processed
        scans (the reference's 0.2-1 Hz thread).

        `mission_log`: JSONL path, one record per mapping step (pose,
        diagnostics, FSM mode, counts, stage times) and one per accepted
        loop (the rosbag-record equivalent of the reference's topics).

        `fetch_every`: results are read back once every that many scans
        (1 = every scan).  The device-to-host copies start as each scan is
        queued; with N > 1 `process_scan` returns the most recently drained
        result (None until the first batch) and `drain()` flushes the tail.

        `auto_checkpoint`: path of a crash-recovery checkpoint written every
        `checkpoint_every` processed scans and at `close()` (respawn
        parity, module_loam.launch:5-8); `Runner.resume(path, cfg)` restarts
        from it.

        `record_bag`: write the odometry / gpsdata outputs to a ROS1 bag at
        that path, one set of records per drained scan (the reference's
        saveBagFlag, mapOptmization.cpp:243-246); written at `close()`.

        `mesh`: a DeviceMesh (`parallel/mesh.make_mesh`) runs the SHARDED
        mission (`parallel/mission.py`): the map grid and the keyframe
        clouds are split over the mesh's ranks, so total map capacity scales
        with its size (`cfg.registration.grid_table_size` counts buckets A
        RANK); the full correction runs the column-sharded sparse solver
        when `full_solver` selects the sparse backend.  Surface-only
        incremental-map missions only.  Each rank runs its own Runner on
        the same inputs; `global_state()` is the state in the JAX
        package's global layout.  `device` must be the rank's mesh device
        (`parallel/mesh.mesh_device`; "cuda" with no index stands for it)."""
        self.cfg = cfg or get_config("default")
        self.device = torch.device(device)
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            from lio_slam_tpu_torch.parallel import mesh as mesh_mod

            if not isinstance(mesh, DeviceMesh):
                raise TypeError("mesh must be a torch.distributed DeviceMesh "
                                f"(parallel/mesh.make_mesh), not {type(mesh)}")
            mdev = mesh_mod.mesh_device(mesh)
            if (self.device.type != mdev.type
                    or self.device.index not in (None, mdev.index)):
                raise ValueError(
                    f"Runner(device={str(device)!r}) is not this rank's mesh "
                    f"device {mdev}: a CUDA rank runs on its current card "
                    "(torch.cuda.set_device before the mesh is built)")
            self.device = mdev
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Runner(device={str(device)!r}) needs a CUDA device and torch "
                'finds none; pass device="cpu" to run on the CPU')
        self.mesh = mesh
        self._is_writer = True        # the rank that writes files
        sharded = None
        if mesh is not None:
            import torch.distributed as dist

            from lio_slam_tpu_torch.parallel import mission as pmission

            sharded = pmission.make_sharded_map_ops(mesh, self.cfg)
            self._is_writer = dist.get_rank() == 0
        # the map backend; gather / shard are identities on one device
        self._ops = sharded or lio.default_map_ops(self.cfg, self.device)
        self.loop_every = int(loop_every)
        self.fetch_every = max(int(fetch_every), 1)
        self._auto_checkpoint = auto_checkpoint
        self._checkpoint_every = max(int(checkpoint_every), 1)
        # deferred-fetch queue: (epoch stamp, mission t, mode, host copies of
        # the scan's results, the event their copies complete at)
        self._pending: list[tuple] = []
        self.step = lio.make_lio_step(self.cfg, ops=sharded,
                                      device=self.device)
        self._prep = self._make_prep()
        self.full_correct = lio.make_full_correction(self.cfg, ops=sharded,
                                                     device=self.device)
        self.detector = loop_closure.make_loop_detector(
            self.cfg, rows=self._ops.keyframe_rows)
        self.correct, self.predict_rate, self.transform_fusion = \
            fe.make_frontend(self.cfg.imu)
        self.local_map_fn, self.height_map_fn = outputs.make_local_map_fn(self.cfg)
        self.state = lio.init_state(self.cfg, device=self.device,
                                    ops=self._ops)
        self.imu_state = fe.init_state(device=self.device)
        self.gps_intake = gf.GpsIntake(self.cfg.gps)
        self.fsm = gf.PositioningModeFSM(self.cfg.gps)
        self.scan_count = 0
        self.trajectory: list[np.ndarray] = []
        self.mapping_error = False
        self.keyframe_evictions = 0
        self._mission_log = (open(mission_log, "w")
                             if mission_log and self._is_writer else None)
        self._bag = (rb.BagWriter(record_bag)
                     if record_bag and self._is_writer else None)
        self._log_counts = (0, 0, 0)
        self._last_pose_dev: Optional[torch.Tensor] = None
        self._imu_ready = False
        self._last_correct_t: Optional[float] = None
        # whether needs_full_solve could be set: only once a loop detector
        # has run, a constraint was injected or a GPS candidate reached the
        # step; until then the per-scan read of the flag is skipped
        self._full_correct_armed = False
        # indices (0-based, among processed scans) of the scans after
        # whose mapping step a full correction ran
        self.full_correction_scans: list[int] = []
        # provenance of the last loop-detector cycle (host numpy; None
        # before the first): loop_accepted, loop_pair_i/j, loop_fitness for
        # [radius search, Scan Context], loop_iters (GN iterations of each
        # verification that ran)
        self.last_loop_aux: Optional[dict] = None
        # last raw vehicle GPS record (lat, lon, alt, heading?, stamp): the
        # "gpsdata" side of the sensor_fusion_output arbitration (:707-724)
        self._last_raw_fix: Optional[tuple] = None
        # a ScanResult drained by an out-of-band caller (health(),
        # fusion_output(), a checkpoint) between batch boundaries, handed
        # back by the next process_scan so that no result is lost
        self._buffered_result: Optional[ScanResult] = None
        # the host-spill keyframe archive (pipeline/archive.py): every
        # keyframe spills to host memory as it is created, and retrieval
        # covers the evicted history, so cross-lap loops survive device-store
        # eviction (the reference's unbounded iSAM2 + Scan Context,
        # mapOptmization.cpp:2097-2134, Scancontext.cpp:253-296)
        self.archive_enabled = bool(self.cfg.loop.enabled
                                    and self.cfg.loop.archive_enabled)
        self._archive = None
        self._kf_snapshot = None
        self._archive_verify = None      # built on the first match
        self.archive_loops = 0           # accepted archive loop constraints
        self.archive_gaps = 0            # gid discontinuities seen/repaired
        self._last_archive_attempt_t = -1e18
        if self.archive_enabled:
            self._archive = arch_mod.KeyframeArchive(
                self.cfg.static.sc_num_ring, self.cfg.static.sc_num_sector)
            self._kf_snapshot = arch_mod.make_kf_snapshot()
        self._last_processed_stamp = -1e18
        # mission-time origin: epoch stamps (~1.7e9 s) have a float32 ulp of
        # 128 s, so every time is rebased to seconds since the first message
        # in float64 on the host, and only the small values reach the device
        self._t0: Optional[float] = None
        self._ext_R = np.asarray(self.cfg.imu.ext_rot, np.float32).reshape(3, 3)
        self._ext_RPY = np.asarray(self.cfg.imu.ext_rpy, np.float32).reshape(3, 3)
        self.timer = profiling.StageTimer()
        self.scan_rate = profiling.RateMonitor(
            expected_hz=1.0 / max(self.cfg.mapping_process_interval, 0.1))

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def global_state(self, grid: bool = True) -> lio.LioState:
        """The mission state in the JAX package's global layout: with a
        mesh, the sharded keyframe clouds (and with `grid` the map grid)
        gathered from every rank, a collective every rank must call; else
        the state itself."""
        return self._ops.gather(self.state, grid=grid)

    def on_raw_gps(self, stamp: float, lat: float = None, lon: float = None,
                   alt: float = None, heading: float = None) -> int:
        """Raw vehicle-GPS stream ("gpsdata" role, gpsDataHandler
        :616-726): every raw fix steps the positioning-mode FSM against the
        corrected stream's last timestamp and caches the raw record for the
        sensor_fusion_output arbitration.  `stamp` is epoch seconds.
        Returns the current mode (the /positioning_mode output)."""
        mode = self.fsm.step(float(stamp), now=float(stamp))
        if lat is not None:
            self._last_raw_fix = (float(lat), float(lon), float(alt),
                                  None if heading is None else float(heading),
                                  float(stamp))
        return mode

    def _prep_imu_window(self, imu: Optional[dict], scan_stamp: float = 0.0):
        """Pad an IMU window {acc (T,3), gyr (T,3), stamps (T,)} to the
        static window size, rotated into the lidar frame (imuConverter).
        Returns host numpy (acc, gyr, dts, rel_times, mask, have)."""
        W = self.cfg.static.max_imu_window
        if imu is None or len(imu.get("stamps", [])) == 0:
            z3 = np.zeros((W, 3), np.float32)
            z = np.zeros(W, np.float32)
            return (z3, z3, z, z, np.zeros(W, bool), False)
        acc = np.asarray(imu["acc"], np.float32) @ self._ext_R.T
        gyr = np.asarray(imu["gyr"], np.float32) @ self._ext_R.T
        stamps = np.asarray(imu["stamps"], np.float64)
        dt = np.diff(stamps, prepend=stamps[0] - 1.0 / self.cfg.imu.imu_rate)
        rel = (stamps - scan_stamp).astype(np.float32)
        n = min(len(stamps), W)
        pad = lambda a, sh: np.concatenate(
            [a[:n], np.zeros((W - n,) + sh, a.dtype)])
        return (pad(acc, (3,)), pad(gyr, (3,)),
                pad(dt.astype(np.float32), ()), pad(rel, ()),
                np.arange(W) < n, True)

    def _make_prep(self):
        """Scan prep: deskew + range/crop filter + LOAM corner extraction
        (when `use_corner_features`) + ring/point decimation over the padded
        raw cloud (projectPointCloud, imageProjection.cpp:577-615;
        featureExtraction.cpp:141-237).  Returns (cloud, corner), corner
        None when the corner term is off."""
        cfg = self.cfg
        lid = cfg.lidar

        def prep(xyz, ptime, pmask, ring, gyr, rel_times, imask, have_imu,
                 pos_inc):
            table = deskew_mod.build_rotation_table(gyr, rel_times, imask)
            pos_arg, dur = None, None
            if lid.deskew_position:
                pos_arg, dur = pos_inc, lid.sweep_time
            desk = deskew_mod.deskew(xyz, ptime, pmask & have_imu, table,
                                     pos_increment=pos_arg,
                                     scan_duration=dur)
            cloud = pc.filter_points(pc.Cloud(xyz=desk, mask=pmask),
                                     lid.lidar_min_range, lid.lidar_max_range,
                                     lid.crop_box_min, lid.crop_box_max)
            corner = None
            if cfg.registration.use_corner_features:
                # off the full-resolution filtered cloud: the reference
                # extracts before any decimation
                corner = extract_corners(desk, cloud.mask, ring, cfg)
            if lid.point_filter_num > 1 or lid.downsample_rate > 1:
                cloud = pc.decimate(cloud, lid.point_filter_num, ring=ring,
                                    downsample_rate=lid.downsample_rate)
            return cloud, corner

        return prep

    def _pad_raw(self, scan: formats.StandardScan):
        """Host-side fixed-shape padding of the raw scan arrays."""
        N = self.cfg.static.max_raw_points
        n = min(len(scan.xyz), N)
        xyz = np.zeros((N, 3), np.float32)
        xyz[:n] = np.asarray(scan.xyz[:n], np.float32)
        t = np.zeros(N, np.float32)
        if scan.time is not None and len(scan.time):
            t[:n] = np.asarray(scan.time[:n], np.float32)
        ring = np.zeros(N, np.int32)
        if scan.ring is not None and len(scan.ring):
            ring[:n] = np.asarray(scan.ring[:n], np.int32)
        return xyz, t, np.arange(N) < n, ring

    def _imu_rpy(self, imu: Optional[dict], scan_stamp: float, have_imu: bool):
        """9-axis attitude at scan start (imuDeskewInfo :381-385): the
        measured orientation nearest the scan, rotated by extQRPY; else the
        front-end's attitude."""
        zero = torch.zeros(3, dtype=torch.float32, device=self.device)
        if not (have_imu and self.cfg.imu.imu_type == 1):
            return zero
        quat = None if imu is None else imu.get("quat")
        q = None
        if quat is not None and len(quat):
            k = int(np.argmin(np.abs(
                np.asarray(imu["stamps"], np.float64) - scan_stamp)))
            q = np.asarray(quat[k], np.float64)
        if q is not None and np.isfinite(q).all() \
                and abs(float(np.linalg.norm(q)) - 1.0) < 0.1:
            w, x, y, z = q[3], q[0], q[1], q[2]        # ros xyzw -> wxyz
            n = np.sqrt(w * w + x * x + y * y + z * z)
            w, x, y, z = w / n, x / n, y / n, z / n
            R_meas = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
            R = R_meas @ self._ext_RPY
            return self._dev(np.array([
                np.arctan2(R[2, 1], R[2, 2]),
                np.arcsin(np.clip(-R[2, 0], -1.0, 1.0)),
                np.arctan2(R[1, 0], R[0, 0])], dtype=np.float32))
        if self._imu_ready:
            return se3.matrix_to_rpy(self.imu_state.nav.R)
        return zero

    def _gps_intake(self, t: float, scan_stamp: float, gps_fix, gps_fixes):
        """The scan's GPS candidates through the FSM, the intake and the
        covariance gate.  Returns (mode, gps_pos (3,), gps_info (3,),
        gps_valid) as host values: the first candidate passing every gate
        becomes the factor's measurement."""
        cfg = self.cfg
        candidates = []
        if gps_fixes:
            candidates = list(gps_fixes)
        elif gps_fix is not None:
            candidates = [(scan_stamp, *gps_fix[:3],
                           gps_fix[3] if len(gps_fix) > 3 else 0,
                           gps_fix[4] if len(gps_fix) > 4 else None)]
        mode = gf.MODE_NORMAL
        gps_pos = np.zeros(3, np.float32)
        gps_info = np.zeros(3, np.float32)
        gps_valid = False
        if not (candidates and cfg.gps.use_gps):
            return mode, gps_pos, gps_info, gps_valid
        # candidates are the CORRECTED stream ("GPSmsg" role): they mark the
        # FSM's corrected-side timestamp; the raw vehicle stream drives the
        # transitions via on_raw_gps (:625-660).  FSM time is epoch seconds
        # so both sides share a clock.
        self.fsm.on_gps(max(float(c[0]) for c in candidates))
        mode = self.fsm.mode
        for c in candidates:
            _, lat, lon, alt = c[:4]
            status = c[4] if len(c) > 4 else 0
            gps_cov = (np.asarray(c[5], np.float64)
                       if len(c) > 5 and c[5] is not None else None)
            # EVERY fix passes through the intake: datum averaging and the
            # jump gate must see the full stream
            obs = self.gps_intake.on_fix(
                t, lat, lon, alt, status, covariance=gps_cov,
                mode_normal=(mode == gf.MODE_NORMAL))
            # message-covariance gate (addGPSFactor :1984-1989)
            cov_ok = (obs is not None and
                      float(max(obs.covariance[0], obs.covariance[1]))
                      <= cfg.gps.gps_cov_threshold)
            if obs is not None and obs.accurate and cov_ok and not gps_valid:
                gps_pos = obs.enu.astype(np.float32)
                # factor variances floored at 1.0 m^2 like the reference
                # (addGPSFactor :2030): GPS softly anchors the global frame
                gps_info = (1.0 / np.maximum(obs.covariance, 1.0)) \
                    .astype(np.float32)
                gps_valid = True
        return mode, gps_pos, gps_info, gps_valid

    def process_scan(self, scan: formats.StandardScan,
                     imu: Optional[dict] = None,
                     gps_fix: Optional[tuple] = None,
                     gps_fixes: Optional[list] = None) -> Optional[ScanResult]:
        """Process one scan.  `gps_fix`: optional (lat, lon, alt, status[,
        covariance]) at about scan time; `gps_fixes`: optional list of
        candidate fixes (stamp, lat, lon, alt, status, covariance) in time
        order (the reference's per-keyframe GPS-queue scan, addGPSFactor
        :1961-1976).  Returns None when the mappingProcessInterval throttle
        drops the scan."""
        cfg = self.cfg
        if self._t0 is None:
            first = float(scan.stamp)
            if imu is not None and len(imu.get("stamps", [])):
                first = min(first, float(imu["stamps"][0]))
            self._t0 = first
        t = float(scan.stamp) - self._t0   # mission-relative seconds (f64)
        if (t - self._last_processed_stamp) < cfg.mapping_process_interval:
            return None
        self._last_processed_stamp = t
        self.scan_rate.tick(t)
        acc, gyr, dts, rel_t, imask, have_imu = \
            self._prep_imu_window(imu, scan_stamp=float(scan.stamp))
        # deskew sees the whole window; the correction integrates up to the
        # scan start only (the feed starts the next window after the samples
        # taken here: live.CORRECTION_MARGIN is the one rule of both)
        imask_corr = imask & (rel_t <= live.CORRECTION_MARGIN)
        acc, gyr, dts, rel_t, imask, imask_corr = map(
            self._dev, (acc, gyr, dts, rel_t, imask, imask_corr))

        stale = (self._last_correct_t is not None
                 and (t - self._last_correct_t) > cfg.imu.max_correction_age)
        fused_rate = None
        rate_poses = None
        with self.timer.stage("imu_predict"):
            if self._imu_ready and have_imu and not stale:
                rate_poses = self.predict_rate(self.imu_state, acc, gyr, dts,
                                               imask_corr)
                guess, gvalid = rate_poses[-1], True
                if self._last_pose_dev is not None:
                    fused_rate = self.transform_fusion(
                        self._last_pose_dev, rate_poses[0], rate_poses)
            else:
                gvalid = self._last_pose_dev is not None
                guess = (self._last_pose_dev if gvalid else
                         torch.zeros(6, dtype=torch.float32, device=self.device))

        pos_inc = torch.zeros(3, dtype=torch.float32, device=self.device)
        if cfg.lidar.deskew_position and rate_poses is not None:
            first, last = rate_poses[0], rate_poses[-1]
            pos_inc = se3.pose6_to_Rt(first)[0].T @ (last[3:] - first[3:])
        with self.timer.stage("deskew"):
            xyz_p, t_p, mask_p, ring_p = map(self._dev, self._pad_raw(scan))
            cloud, corner = self._prep(xyz_p, t_p, mask_p, ring_p, gyr,
                                       rel_t, imask, have_imu, pos_inc)

        mode, gps_pos, gps_info, gps_valid = self._gps_intake(
            t, float(scan.stamp), gps_fix, gps_fixes)
        imu_rpy = self._imu_rpy(imu, float(scan.stamp), have_imu)
        f32 = dict(dtype=torch.float32, device=self.device)
        as_bool = lambda v: torch.tensor(bool(v), device=self.device)
        inp = lio.ScanInput(
            cloud=cloud, stamp=torch.tensor(t, **f32), init_guess=guess,
            guess_valid=as_bool(gvalid), imu_rpy=imu_rpy,
            imu_available=as_bool(have_imu),
            gps_pos=self._dev(gps_pos), gps_info=self._dev(gps_info),
            gps_valid=as_bool(gps_valid), corner=corner)
        with self.timer.stage("mapping_step"):
            self.state, out = self.step(self.state, inp)

        # full-graph correction when the step consumed loop or GPS factors.
        # It runs BEFORE the front-end correction so the front-end is
        # re-anchored in the CORRECTED frame: corrected with the
        # pre-correction pose, the front-end frame and the map frame drift
        # apart scan over scan (each correction moves the map, the front-end
        # keeps predicting in the stale frame and misguides the next
        # registration).  The reference orders the same way
        # (laserCloudInfoHandler, mapOptmization.cpp:432-506).  Once armed it
        # stays armed: queued loop constraints are consumed at a LATER
        # keyframe save.
        if gps_valid:
            self._full_correct_armed = True
        if self._full_correct_armed:
            with self.timer.stage("full_correction"):
                before = self.state
                self.state = self.full_correct(self.state)
                if self.state is not before:
                    self.full_correction_scans.append(self.scan_count)
        pose_dev = self.state.pose.clone()
        self._last_pose_dev = pose_dev

        if have_imu:
            with self.timer.stage("imu_frontend"):
                if stale and self._imu_ready:
                    # correction gap: re-anchor instead of correcting across it
                    self.imu_state = fe.reinitialize(self.imu_state, pose_dev)
                else:
                    self.imu_state = self.correct(self.imu_state, acc, gyr,
                                                  dts, imask_corr, pose_dev,
                                                  out.degenerate)
            self._imu_ready = True
            self._last_correct_t = t
        # loop-closure cadence (the reference's 0.2-1 Hz thread)
        self.scan_count += 1
        loop_aux = None
        archive_attempt_due = False
        if cfg.loop.enabled and self.scan_count % self.loop_every == 0:
            with self.timer.stage("loop_closure"):
                self.state, loop_aux = self.detector(self.state)
                self.last_loop_aux = {
                    k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in loop_aux.items()}
            self._full_correct_armed = True
            # the archive tier: retrieval over EVICTED keyframes (the device
            # detector sees only the live store).  It runs after this scan's
            # snapshot is queued (below), so that the archive is current
            # through this scan
            archive_attempt_due = self._archive is not None

        # queue what the host needs of this step; the copies start now and
        # are read once every `fetch_every` scans (drain).  The published
        # pose is the post-correction one (publishOdometry consumes
        # transformTobeMapped after correctPoses)
        fetch = {"pose": pose_dev, "incremental": out.incremental,
                 "degenerate": out.degenerate, "num_inliers": out.num_inliers,
                 "evictions": out.evictions}
        if have_imu:
            fetch["imu_failure"] = self.imu_state.failure
        if rate_poses is not None:
            fetch["rate_poses"] = rate_poses
        if fused_rate is not None:
            fetch["fused_rate"] = fused_rate
        if self._mission_log is not None:
            fetch.update(kf_count=self.state.store.count,
                         loop_count=self.state.loop_count,
                         gps_count=self.state.gps_count)
        if loop_aux is not None:
            # loop provenance (the rviz loop markers,
            # mapOptmization.cpp:1385-1436): mission-log events at drain
            fetch.update({k: loop_aux[k] for k in (
                "loop_accepted", "loop_pair_i", "loop_pair_j", "loop_fitness")})
        if self._kf_snapshot is not None:
            snap = self._kf_snapshot(self.state)
            if self.mesh is not None:
                # the newest keyframe's cloud from every rank's slice
                from lio_slam_tpu_torch.parallel import mesh as mesh_mod
                for k in ("arch_cloud", "arch_cloud_mask"):
                    snap[k] = mesh_mod.gather_sharded(snap[k], self.mesh)
            fetch.update(snap)
        known = {"is_keyframe": out.is_keyframe,
                 "registration_iters": out.registration_iters}
        self._pending.append((float(scan.stamp), t, mode, known,
                              *self._start_fetch(fetch)))
        if archive_attempt_due:
            with self.timer.stage("archive_loop"):
                self._attempt_archive_loop(t)
        result = None
        if len(self._pending) >= self.fetch_every:
            # keep the newest entry queued (double buffering): its copies
            # were started a moment ago, the older ones have landed
            result = self.drain(keep_last=1 if self.fetch_every > 1 else 0)
        if result is None and self._buffered_result is not None:
            # an out-of-band drain consumed the batch early: hand its result
            # back now
            result, self._buffered_result = self._buffered_result, None
        if (self._auto_checkpoint is not None
                and self.scan_count % self._checkpoint_every == 0):
            self.save_checkpoint(self._auto_checkpoint)
        return result

    def _start_fetch(self, fetch: dict):
        """(host tensors, event): copies of `fetch` on the host.  On CUDA
        they are asynchronous copies into pinned memory, complete once the
        event has; on the CPU they are clones (no later write to a state
        tensor may reach a queued result)."""
        if self.device.type != "cuda":
            return {k: v.clone() for k, v in fetch.items()}, None
        host = {}
        for k, v in fetch.items():
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def drain(self, keep_last: int = 0) -> Optional[ScanResult]:
        """Flush the deferred-fetch queue: wait for the pending copies, then
        emit their ScanResults (trajectory, archive, mission log).  Returns
        the newest drained result, or None if nothing was pending.
        `keep_last > 0` leaves the newest entries queued."""
        if len(self._pending) <= keep_last:
            return None
        cut = len(self._pending) - keep_last
        pending, self._pending = self._pending[:cut], self._pending[cut:]
        with self.timer.stage("host_fetch"):
            all_vals = []
            for (*_, host, done) in pending:
                if done is not None:
                    done.synchronize()
                # copies: a result kept by the caller must not hold on to
                # a pinned block
                all_vals.append({k: v.numpy().copy() for k, v in host.items()})
        result = None
        for (stamp, t, mode, known, _, _), vals in zip(pending, all_vals):
            vals.update(known)
            pose = vals["pose"]
            self.trajectory.append(pose)
            if self._archive is not None and "arch_kf_count" in vals:
                self._feed_archive(vals)
            if "imu_failure" in vals:
                self.mapping_error = bool(vals["imu_failure"])
            self.keyframe_evictions = int(vals["evictions"])
            result = ScanResult(
                pose=pose, incremental=vals["incremental"],
                degenerate=bool(vals["degenerate"]),
                is_keyframe=bool(vals["is_keyframe"]),
                num_inliers=int(vals["num_inliers"]), positioning_mode=mode,
                imu_rate_poses=vals.get("rate_poses"),
                fused_rate_poses=vals.get("fused_rate"),
                registration_iters=vals["registration_iters"])
            if self._mission_log is not None:
                self._log_counts = (int(vals["kf_count"]),
                                    int(vals["loop_count"]),
                                    int(vals["gps_count"]))
            if self._bag is not None:
                self._record_outputs(stamp, result)
            if self._mission_log is not None:
                self._log_step(stamp, t, result)
                if "loop_accepted" in vals:
                    ev = self.keyframe_evictions
                    for k, src in enumerate(("rs", "sc")):
                        if bool(vals["loop_accepted"][k]):
                            self._log_loop_event(
                                t, int(vals["loop_pair_i"][k]) + ev,
                                int(vals["loop_pair_j"][k]) + ev,
                                float(vals["loop_fitness"][k]), src)
        return result

    def _drain_buffered(self):
        """Drain for an out-of-band reader, buffering the ScanResult so that
        the next process_scan still returns it."""
        r = self.drain()
        if r is not None:
            self._buffered_result = r

    def _log_loop_event(self, t: float, i: int, j: int, fitness: float,
                        source: str):
        """One JSONL event per accepted loop constraint: (i, j, fitness,
        source in {rs, sc, archive, injected}), the recorded form of the
        reference's rviz loop markers (mapOptmization.cpp:1385-1436).  i, j
        are GLOBAL keyframe ids (device slot + evictions at event time), so
        chords stay meaningful across evictions."""
        if self._mission_log is None:
            return
        self._mission_log.write(json.dumps({
            "event": "loop", "t": round(float(t), 6), "i": int(i),
            "j": int(j), "fitness": round(float(fitness), 5),
            "source": source}) + "\n")

    def _log_step(self, stamp: float, t: float, r: ScanResult):
        """One JSONL record per mapping step: pose, health, counts, FSM
        mode, stage times."""
        rec = {
            "stamp": float(stamp), "t": round(float(t), 6),
            "pose": [round(float(v), 6) for v in r.pose],
            "degenerate": r.degenerate, "keyframe": r.is_keyframe,
            "inliers": r.num_inliers, "mode": r.positioning_mode,
            "keyframes": self._log_counts[0],
            "loops": self._log_counts[1],
            "gps_factors": self._log_counts[2],
            "evictions": self.keyframe_evictions,
            "mapping_error": self.mapping_error,
            "scan_rate_hz": round(self.scan_rate.hz, 2),
        }
        last = self.timer.last()
        if last:
            rec["stage_ms"] = {k: round(v * 1e3, 3) for k, v in last.items()}
        self._mission_log.write(json.dumps(rec) + "\n")

    def _record_outputs(self, stamp: float, r: ScanResult):
        """saveBagFlag parity: per mapping step, write the global odometry
        (and gpsdata once an ENU datum exists) to the output bag, carrying the
        degenerate flag in covariance[0] (publishOdometry :2309-2312)."""
        q = se3.matrix_to_quat(se3.rpy_to_matrix(
            torch.from_numpy(r.pose[:3]))).numpy().astype(np.float64)  # wxyz
        quat_xyzw = np.array([q[1], q[2], q[3], q[0]])
        cov = np.zeros(36)
        cov[0] = 1.0 if r.degenerate else 0.0
        self._bag.write(
            "/liorf/mapping/odometry", "nav_msgs/Odometry",
            rb.encode_odometry(stamp, r.pose[3:6].astype(np.float64),
                               quat_xyzw, pose_covariance=cov,
                               frame_id="odom", child="base_link"), stamp)
        if self.gps_intake.datum is not None:
            fo = self.fusion_output(stamp)
            self._bag.write(
                "/liorf/gpsdata", "sensor_driver_msgs/GpswithHeading",
                rb.encode_gps_with_heading(
                    stamp, fo.latitude, fo.longitude, fo.altitude,
                    fo.heading, fo.pitch, fo.roll, mode=fo.mode), stamp)
            # the FSM-arbitrated record (gpsDataHandler :707-724)
            so, _src = self.sensor_fusion_output(stamp)
            self._bag.write(
                "/sensor_fusion_output", "sensor_driver_msgs/GpswithHeading",
                rb.encode_gps_with_heading(
                    stamp, so.latitude, so.longitude, so.altitude,
                    so.heading, so.pitch, so.roll, mode=so.mode), stamp)

    def close_bag(self):
        """Write the output bag (its records are held until now)."""
        if self._bag is not None:
            self._bag.close()
            self._bag = None

    # -- the keyframe archive ---------------------------------------------

    def _feed_archive(self, vals: dict):
        """Spill this scan's keyframe (if one was made) into the archive and
        refresh the live-pose mirror.  Each scan's fetch is a consistent
        snapshot of the post-step state, so the keyframe flag, the payload
        and the counters agree."""
        kf_count = int(vals["arch_kf_count"])
        evict = int(vals["arch_evict_count"])
        gid = kf_count + evict - 1          # global id of the newest keyframe
        a = self._archive
        if bool(vals["is_keyframe"]):
            if gid == a.base_gid + len(a):
                mask = vals["arch_cloud_mask"]
                a.add(gid, vals["arch_pose"], float(vals["arch_stamp"]),
                      vals["arch_cloud"][mask], vals["arch_desc"])
            elif gid > a.base_gid + len(a):
                # the archive lost step with the device counters (a stale
                # sidecar that load_checkpoint could not reconcile): count
                # it and warn once rather than freeze the tier in silence
                self.archive_gaps += 1
                if self.archive_gaps == 1:
                    warnings.warn(
                        f"keyframe archive gap: expected gid "
                        f"{a.base_gid + len(a)}, device reports {gid}; "
                        "archive additions suspended (stale sidecar?)")
        a.refresh_live_poses(evict, vals["arch_all_poses"], kf_count)

    def _reconcile_archive(self):
        """Reconcile a loaded archive sidecar with the restored state: a
        sidecar that lags the checkpoint (a crash between the two saves)
        would fail `_feed_archive`'s continuity check forever.  Keyframes it
        lacks are topped up from the live store; history already evicted
        from the device is gone, so a deeper gap rebuilds from the store
        with base_gid marking the loss."""
        a = self._archive
        evict = int(self.state.evict_count)
        count = int(self.state.store.count)
        next_expected = evict + count       # gid the next keyframe will get
        have_through = a.base_gid + len(a)
        if have_through >= next_expected:
            return                           # sidecar current (or ahead)
        if have_through < evict:
            self._archive = arch_mod.KeyframeArchive.from_state(
                self.global_state(grid=False))
            self.archive_gaps += 1
            return
        host = lambda x: x.cpu().numpy()
        st = self.state
        lo = have_through - evict            # first device store slot needed
        descs, poses = host(st.sc_db.descriptors), host(st.store.poses)
        stamps = host(st.store.stamps)
        clouds, masks = (host(x) for x in self._ops.keyframe_rows(
            st.store, torch.arange(lo, count, device=self.device)))
        for gid in range(have_through, next_expected):
            i = gid - evict                  # device store slot
            a.add(gid, poses[i], float(stamps[i]),
                  clouds[i - lo][masks[i - lo]], descs[i])
        a.evict_count = max(a.evict_count, evict)

    def _attempt_archive_loop(self, t: float):
        """Full-history loop retrieval and re-promotion (the archive half of
        performSCLoopClosure): match the newest keyframe against the evicted
        descriptors on the host; on a hit, promote the +-search_num archived
        submap to the device, verify it by registration and queue a factor
        anchored to the rebased prior frame (keyframe 0)."""
        l = self.cfg.loop
        if t - self._last_archive_attempt_t < l.archive_cooldown_s:
            return
        self._drain_buffered()       # the archive current through this scan
        hit = self._archive.match(now=t, time_diff=l.time_diff,
                                  dist_thresh=l.sc_dist_thresh,
                                  num_candidates=self.cfg.static.sc_candidates)
        if hit is None:
            return
        gid, yaw, _dist = hit
        self._last_archive_attempt_t = t
        cap = self.cfg.static.max_map_points
        a = self._archive
        pts = a.submap(gid, l.search_num, max_points=cap)
        if pts.shape[0] < 500:
            return
        xyz = np.zeros((cap, 3), np.float32)
        xyz[:pts.shape[0]] = pts
        cand_pose = a.poses[gid - a.base_gid]
        init = arch_mod.compose_yaw_np(cand_pose, yaw)
        # wander gate: the spread of the keyframe POSES promoted into the
        # submap (+ two keyframe spacings and 1 m of slack), capped by the
        # search radius: a verified match must land inside the geometry it
        # was verified against
        lo = max(gid - l.search_num - a.base_gid, 0)
        hi = min(gid + l.search_num + 1 - a.base_gid, len(a))
        kf_pos = np.stack([a.poses[k][3:] for k in range(lo, hi)])
        spread = np.linalg.norm(kf_pos - cand_pose[3:][None, :], axis=1).max()
        max_wander = float(np.float32(min(
            spread + 2.0 * self.cfg.keyframe.dist_threshold + 1.0,
            l.search_radius)))
        if self._archive_verify is None:
            self._archive_verify = arch_mod.make_archive_verifier(
                self.cfg, rows=self._ops.keyframe_rows)
        self.state, added, fit = self._archive_verify(
            self.state, self._dev(xyz), self._dev(np.arange(cap) < pts.shape[0]),
            self._dev(init), max_wander)
        if bool(added):              # one host read at archive-hit rate
            self.archive_loops += 1
            self._full_correct_armed = True
            cur_gid = a.base_gid + len(a) - 1
            self._log_loop_event(t, cur_gid, gid, float(fit), "archive")

    # -- shutdown, products, checkpoints, health --------------------------

    def close(self):
        """Shutdown: drain, write the auto-checkpoint, save the global map
        when cfg.output.save_pcd is set (visualizeGlobalMapThread :981-989
        saves at exit under savePCD), write the output bag, close the
        mission log.  Returns the SaveMapResult or None."""
        self.drain()
        if self._auto_checkpoint is not None and self.scan_count:
            # a clean shutdown leaves the freshest state for resume
            self.save_checkpoint(self._auto_checkpoint)
        result = None
        if self.cfg.output.save_pcd and int(self.state.store.count) > 0:
            result = self.save_map(self.cfg.output.save_directory,
                                   resolution=self.cfg.output.global_map_leaf_size)
        self.close_bag()
        if self._mission_log is not None:
            self._mission_log.close()
            self._mission_log = None
        return result

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _current_pose(self) -> torch.Tensor:
        if self._last_pose_dev is not None:
            return self._last_pose_dev
        return torch.zeros(6, dtype=torch.float32, device=self.device)

    def local_planning_map(self) -> pc.Cloud:
        """The map_4planning cloud around the last pose."""
        return self.local_map_fn(self.global_state(grid=False).store,
                                 self._current_pose())

    def height_map(self):
        """The planning map rasterized about the last pose."""
        return self.height_map_fn(self.local_planning_map(), self._current_pose())

    def save_map(self, destination: str, resolution: float = 0.0):
        """The map PCDs under `destination` (with a mesh: written by rank 0,
        None on the other ranks)."""
        store = self.global_state(grid=False).store
        if not self._is_writer:
            return None
        return outputs.save_map(store, destination, resolution)

    def save_checkpoint(self, path: str):
        """The SLAM state, the IMU front-end state and the host state resume
        needs (scan count, time origin, last stamps), plus the archive as
        `path + ".archive.npz"`."""
        # buffered drain: at an auto-checkpoint inside process_scan a raw
        # drain() would consume the batch's newest result
        self._drain_buffered()
        state = self.global_state()
        if not self._is_writer:
            return
        nan = float("nan")
        checkpoint.save_checkpoint(
            path, state, self.imu_state,
            metadata={"scan_count": self.scan_count,
                      "t0": self._t0 if self._t0 is not None else nan,
                      "last_stamp": self._last_processed_stamp,
                      # the staleness gate must survive resume: a resume
                      # spans real downtime, and correcting across it is the
                      # velocity runaway the gate prevents
                      "last_correct_t": (self._last_correct_t
                                         if self._last_correct_t is not None
                                         else nan)})
        if self._archive is not None:
            self._archive.save(path + ".archive.npz")

    @classmethod
    def resume(cls, path: str, cfg: Optional[Config] = None, **kwargs):
        """Resume on crash (respawn parity, module_loam.launch:5-8): a Runner
        for `cfg` (keyword arguments as the constructor's) with the
        checkpoint at `path` restored."""
        runner = cls(cfg, **kwargs)
        runner.load_checkpoint(path)
        return runner

    def load_checkpoint(self, path: str) -> dict:
        """Restore a checkpoint (either package's) onto this Runner's
        device; returns its metadata.  Not in a checkpoint: the GPS intake
        and positioning-mode FSM, the loop detector's last cycle and the
        trajectory before it (rebuilt from the keyframe poses), as in the
        JAX package."""
        # queued fetches belong to the discarded state
        self._pending.clear()
        self.state, imu_state, meta = checkpoint.load_checkpoint(
            path, self.cfg, device=self.device, ops=self._ops)
        if imu_state is not None:
            self.imu_state = imu_state
            self._imu_ready = bool(imu_state.initialized)
        self.scan_count = int(meta.get("scan_count", 0))
        self.keyframe_evictions = int(self.state.evict_count)
        # the restored state may carry queued loops or a raised
        # needs_full_solve
        self._full_correct_armed = True
        t0 = float(meta.get("t0", float("nan")))
        self._t0 = None if np.isnan(t0) else t0
        self._last_processed_stamp = float(meta.get("last_stamp", -1e18))
        # re-arm the staleness gate; a checkpoint without the field treats
        # the first correction after resume as stale
        lct = float(meta.get("last_correct_t", float("nan")))
        if np.isnan(lct):
            self._last_correct_t = -1e18 if self._imu_ready else None
        else:
            self._last_correct_t = lct
        if self._archive is not None:
            apath = path + ".archive.npz"
            if os.path.exists(apath):
                self._archive = arch_mod.KeyframeArchive.load(apath)
                self._reconcile_archive()
            else:
                # no sidecar: rebuild from the live store (the evicted
                # history is lost; base_gid marks it)
                self._archive = arch_mod.KeyframeArchive.from_state(
                    self.global_state(grid=False))
        n = int(self.state.store.count)
        if n > 0:
            poses = self.state.store.poses[:n].cpu().numpy()
            self.trajectory = [poses[i] for i in range(n)]
            self._last_pose_dev = self.state.store.poses[n - 1].clone()
        return meta

    def health(self) -> dict:
        """A `rostopic hz`-style health snapshot (README.md:308-322).  It
        drains the queue first so the flags reflect the latest scan; the
        drained result is handed back by the next process_scan."""
        self._drain_buffered()
        h = {"scan_rate_hz": round(self.scan_rate.hz, 2),
             "scan_rate_healthy": self.scan_rate.healthy,
             "mapping_error": self.mapping_error,
             "keyframe_evictions": self.keyframe_evictions,
             # once evictions have removed Scan Context candidates, cross-lap
             # loops stop unless the archive serves them
             "loop_memory_exhausted": (self.keyframe_evictions > 0
                                       and not self.archive_enabled)}
        if self._archive is not None:
            h["archived_keyframes"] = len(self._archive)
            h["archive_loops"] = self.archive_loops
            h["archive_gaps"] = self.archive_gaps
        return h

    def fusion_output(self, stamp: float) -> gf.FusionOutput:
        """The SLAM pose as a geodetic record (fusionGps :2374-2430)."""
        self._drain_buffered()   # no-op mid-drain (_pending already popped)
        pose = self.trajectory[-1] if self.trajectory else np.zeros(6)
        return gf.fusion_gps_output(pose.astype(np.float64), stamp,
                                    self.gps_intake.transform, self.fsm.mode)

    def sensor_fusion_output(self, stamp: float):
        """The arbitrated `sensor_fusion_output` record (gpsDataHandler
        :707-724): the FSM's `select_source` decides whether the SLAM-fused
        geodetic record or the raw vehicle GPS record is published.  Returns
        (FusionOutput, source) with source in {"fusion", "raw"}."""
        fused = self.fusion_output(stamp)
        raw = self._last_raw_fix
        raw_heading = (raw[3] if raw is not None and raw[3] is not None
                       else fused.heading)
        src = self.fsm.select_source(fused.heading, raw_heading)
        if src == "raw" and raw is not None:
            return gf.FusionOutput(
                stamp=stamp, latitude=raw[0], longitude=raw[1],
                altitude=raw[2], heading=raw_heading,
                roll=0.0, pitch=0.0, mode=self.fsm.mode), "raw"
        return fused, "fusion"

    def inject_loop_constraint(self, i: int, j: int, meas,
                               info=None) -> bool:
        """External loop-constraint feed (detectLoopClosureExternal,
        mapOptmization.cpp:1306-1358): a constraint between live keyframes
        i and j is queued into the pending-loop slots and consumed by the
        next keyframe's addLoopFactor.  `meas`: (6,) pose6 relative
        measurement X_i^-1 X_j; `info`: (6,) information diagonal (default:
        the stiffness of a loop of fitness 0.3).  Returns whether the
        constraint was accepted (endpoints live, queue not full)."""
        if info is None:
            info = np.full(6, 1.0 / 0.3 ** 2, np.float32)
        self.state, accepted = lio.inject_loop_constraint(
            self.state, int(i), int(j),
            self._dev(np.asarray(meas, np.float32)),
            self._dev(np.asarray(info, np.float32)))
        self._full_correct_armed = True
        ok = bool(accepted)
        if ok:
            ev = self.keyframe_evictions
            self._log_loop_event(
                self._last_processed_stamp, int(i) + ev, int(j) + ev,
                float(np.min(1.0 / np.sqrt(np.maximum(np.asarray(info), 1e-12)))),
                "injected")
        return ok


def _run_synthetic(args):
    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    cfg = get_config(args.preset)
    runner = _cli_runner(args, cfg)
    seq = synthetic.make_sequence(n_scans=args.scans, n_points=args.points,
                                  seed=args.seed)
    scans, imus = sm.synthetic_inputs(seq, cfg)
    t0 = time.perf_counter()
    done = {}             # scan index -> pose; a resumed run skips the scans
    for i in range(args.scans):        # its checkpoint had already processed
        r = runner.process_scan(scans[i], imu=imus[i])
        if r is not None:
            done[i] = r.pose
    if runner.device.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    ate = (synthetic.ate_rmse(np.stack(list(done.values())),
                              sm.relative_truth(seq)[list(done)])
           if done else float("nan"))
    summary = {
        "device": str(runner.device), "scans": args.scans,
        "processed": len(done),
        "elapsed_s": round(elapsed, 3),
        "scans_per_sec": round(args.scans / elapsed, 3),
        "ate_rmse_m": round(float(ate), 5) if done else None,
        "keyframes": int(runner.state.store.count),
        "loops": int(runner.state.loop_count),
        "full_corrections": len(runner.full_correction_scans),
        "mapping_error": runner.mapping_error}
    _finish(args, runner, summary)


def _cli_runner(args, cfg: Config) -> Runner:
    runner = Runner(cfg, device=args.device, loop_every=args.loop_every,
                    record_bag=args.record_bag, mission_log=args.mission_log,
                    auto_checkpoint=args.auto_checkpoint,
                    checkpoint_every=args.checkpoint_every)
    if args.resume_from:
        runner.load_checkpoint(args.resume_from)
    return runner


def _finish(args, runner: Runner, summary: dict):
    """The CLI's end of a mission: the saved map, the output bag, the
    summary line and the timing report."""
    if args.save_map:
        summary["saved"] = runner.save_map(args.save_map, resolution=0.4).files
    runner.close()
    if args.record_bag:
        summary["recorded_bag"] = args.record_bag
    print(json.dumps(summary))
    if args.report_timing:
        print(runner.timer.report(), file=sys.stderr)
        print(f"health: {runner.health()}", file=sys.stderr)


def _run_bag(args):
    """rosbag replay: the reference's `rosbag play` + launch workflow
    (src/liorf/README.md:137-158) in one process."""
    from lio_slam_tpu_torch.io.bag_replay import BagTopics, replay_bag

    runner = _cli_runner(args, get_config(args.preset))
    topics = BagTopics(lidar=args.lidar_topic, imu=args.imu_topic,
                       gps=args.gps_topic, sensor=args.sensor)
    t0 = time.perf_counter()
    n = 0
    last = None
    for r in replay_bag(runner, args.bag, topics,
                        max_scans=args.scans or None):
        n += 1
        last = r
    if runner.device.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    summary = {
        "device": str(runner.device), "bag": args.bag, "scans": n,
        "elapsed_s": round(elapsed, 3),
        "scans_per_sec": round(n / max(elapsed, 1e-9), 3),
        "keyframes": int(runner.state.store.count),
        "loops": int(runner.state.loop_count),
        "final_pose": None if last is None else
            [round(float(v), 4) for v in last.pose],
        "mapping_error": runner.mapping_error}
    _finish(args, runner, summary)


def main():
    ap = argparse.ArgumentParser(
        description="lio_slam_tpu_torch mission runner (PyTorch port); the "
                    "preset runs as it is, keyframe archive included")
    ap.add_argument("--synthetic", action="store_true",
                    help="run the synthetic mission")
    ap.add_argument("--bag", default=None, help="replay a ROS1 .bag file")
    ap.add_argument("--lidar-topic", default="/velodyne_points")
    ap.add_argument("--imu-topic", default="/imu/data")
    ap.add_argument("--gps-topic", default=None)
    ap.add_argument("--sensor", default="velodyne",
                    choices=["velodyne", "ouster", "robosense", "mulran",
                             "livox", "rs_xyzi"])
    ap.add_argument("--scans", type=int, default=40,
                    help="scans of the synthetic mission; the most a bag "
                         "replay processes (0: all)")
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preset", default="default")
    ap.add_argument("--loop-every", type=int, default=10,
                    help="run the loop detector every N processed scans")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--save-map", default=None,
                    help="write the map PCDs to this directory at the end")
    ap.add_argument("--record-bag", default=None,
                    help="write odometry/gpsdata outputs to a .bag "
                         "(reference saveBagFlag)")
    ap.add_argument("--report-timing", action="store_true",
                    help="print the per-stage timing report at the end")
    ap.add_argument("--mission-log", default=None,
                    help="write a per-step structured JSONL mission log")
    ap.add_argument("--auto-checkpoint", default=None,
                    help="periodic crash-recovery checkpoint path "
                         "(resume with --resume-from)")
    ap.add_argument("--checkpoint-every", type=int, default=50,
                    help="scans between auto checkpoints")
    ap.add_argument("--resume-from", default=None,
                    help="restore a checkpoint before the mission starts")
    args = ap.parse_args()
    if args.bag:
        _run_bag(args)
    elif args.synthetic:
        _run_synthetic(args)
    else:
        ap.error("pass --synthetic or --bag <file>; "
                 "use the Runner API for live feeds")


if __name__ == "__main__":
    main()
