"""Host-side mission runner (port of `lio_slam_tpu/pipeline/runner.py`).

`Runner(cfg)` drives one scan at a time through the port's main path, on
the CUDA device unless the caller passes `device="cpu"`:

    IMU prediction (predict_rate, TransformFusion) -> scan prep (deskew,
    range/crop filter, decimation) -> GPS intake (FSM, datum, gates) ->
    mapping step (downsample, GN registration through the fused kernel,
    keyframe save with loop and GPS factors) -> full-graph correction and
    map rebuild when a factor landed -> IMU front-end correction -> every
    `loop_every` scans the loop detector (radius search and Scan Context,
    each verified by a registration against a submap grid)

Results come back synchronously (the JAX runner's fetch_every=1).  The
keyframe archive, the sharded mesh, batched fetches, bag recording, mission
logs and checkpoints are not ported yet: asking for any of them raises
NotImplementedError.

CLI:
    python -m lio_slam_tpu_torch.pipeline.runner --synthetic --scans 20 \
        --points 8192 [--loop-every 10] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from lio_slam_tpu_torch.config import Config, get_config
from lio_slam_tpu_torch.io import formats
from lio_slam_tpu_torch.ops import deskew as deskew_mod
from lio_slam_tpu_torch.pipeline import gps_fusion as gf
from lio_slam_tpu_torch.pipeline import imu_frontend as fe
from lio_slam_tpu_torch.pipeline import lio
from lio_slam_tpu_torch.pipeline import loop_closure
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


class Runner:
    def __init__(self, cfg: Optional[Config] = None, device="cuda",
                 loop_every: int = 10,
                 record_bag: Optional[str] = None,
                 mission_log: Optional[str] = None, fetch_every: int = 1,
                 auto_checkpoint: Optional[str] = None, mesh=None):
        """`device`: where every tensor of the mission lives; the card by
        default, and never the CPU unless asked (`device="cpu"`).
        `loop_every`: the loop detector runs every that many processed
        scans (the reference's 0.2-1 Hz thread).  The other arguments
        mirror the JAX Runner's; the features behind them are not ported
        yet, so anything but their defaults raises."""
        self.cfg = cfg or get_config("default")
        unported = {
            "cfg.loop.enabled and cfg.loop.archive_enabled (archive)":
                self.cfg.loop.enabled and self.cfg.loop.archive_enabled,
            "record_bag": record_bag is not None,
            "mission_log": mission_log is not None,
            "fetch_every > 1": int(fetch_every) > 1,
            "auto_checkpoint": auto_checkpoint is not None,
            "mesh": mesh is not None,
        }
        missing = [k for k, v in unported.items() if v]
        if missing:
            raise NotImplementedError(
                "not ported yet: " + ", ".join(missing)
                + " (turn the keyframe archive off with dataclasses.replace("
                "cfg, loop=dataclasses.replace(cfg.loop, "
                "archive_enabled=False)))")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Runner(device={str(device)!r}) needs a CUDA device and torch "
                'finds none; pass device="cpu" to run on the CPU')
        self.loop_every = int(loop_every)
        self.step = lio.make_lio_step(self.cfg, device=self.device)
        self._prep = self._make_prep()
        self.full_correct = lio.make_full_correction(self.cfg,
                                                     device=self.device)
        self.detector = loop_closure.make_loop_detector(self.cfg)
        self.correct, self.predict_rate, self.transform_fusion = \
            fe.make_frontend(self.cfg.imu)
        self.state = lio.init_state(self.cfg, device=self.device)
        self.imu_state = fe.init_state(device=self.device)
        self.gps_intake = gf.GpsIntake(self.cfg.gps)
        self.fsm = gf.PositioningModeFSM(self.cfg.gps)
        self.scan_count = 0
        self.trajectory: list[np.ndarray] = []
        self.mapping_error = False
        self.keyframe_evictions = 0
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
        self._last_processed_stamp = -1e18
        self._t0: Optional[float] = None
        self._ext_R = np.asarray(self.cfg.imu.ext_rot, np.float32).reshape(3, 3)
        self._ext_RPY = np.asarray(self.cfg.imu.ext_rpy, np.float32).reshape(3, 3)
        self.timer = profiling.StageTimer()

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

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
        """Scan prep: deskew + range/crop filter + ring/point decimation
        over the padded raw cloud (projectPointCloud,
        imageProjection.cpp:577-615)."""
        lid = self.cfg.lidar
        if self.cfg.registration.use_corner_features:
            raise NotImplementedError("LOAM corner extraction is not ported")

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
            if lid.point_filter_num > 1 or lid.downsample_rate > 1:
                cloud = pc.decimate(cloud, lid.point_filter_num, ring=ring,
                                    downsample_rate=lid.downsample_rate)
            return cloud

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
        acc, gyr, dts, rel_t, imask, have_imu = \
            self._prep_imu_window(imu, scan_stamp=float(scan.stamp))
        # deskew sees the whole window; the correction integrates up to the
        # scan start only
        imask_corr = imask & (rel_t <= 1e-6)
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
            cloud = self._prep(xyz_p, t_p, mask_p, ring_p, gyr, rel_t, imask,
                               have_imu, pos_inc)

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
            gps_valid=as_bool(gps_valid))
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
        if cfg.loop.enabled and self.scan_count % self.loop_every == 0:
            with self.timer.stage("loop_closure"):
                self.state, aux = self.detector(self.state)
                self.last_loop_aux = {
                    k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in aux.items()}
            self._full_correct_armed = True

        host = lambda x: None if x is None else x.cpu().numpy()
        result = ScanResult(
            pose=host(pose_dev), incremental=host(out.incremental),
            degenerate=bool(out.degenerate), is_keyframe=out.is_keyframe,
            num_inliers=int(out.num_inliers), positioning_mode=mode,
            imu_rate_poses=host(rate_poses), fused_rate_poses=host(fused_rate),
            registration_iters=out.registration_iters)
        self.trajectory.append(result.pose)
        if have_imu:
            self.mapping_error = bool(self.imu_state.failure)
        self.keyframe_evictions = int(out.evictions)
        return result

    def fusion_output(self, stamp: float) -> gf.FusionOutput:
        """The SLAM pose as a geodetic record (fusionGps :2374-2430)."""
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
        return bool(accepted)


def _run_synthetic(args):
    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    base = get_config(args.preset)
    cfg = dataclasses.replace(base, loop=dataclasses.replace(
        base.loop, archive_enabled=False))
    runner = Runner(cfg, device=args.device, loop_every=args.loop_every)
    seq = synthetic.make_sequence(n_scans=args.scans, n_points=args.points,
                                  seed=args.seed)
    scans, imus = sm.synthetic_inputs(seq, cfg)
    t0 = time.perf_counter()
    for i in range(args.scans):
        runner.process_scan(scans[i], imu=imus[i])
    if runner.device.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    ate = synthetic.ate_rmse(np.stack(runner.trajectory),
                             sm.relative_truth(seq))
    print(json.dumps({
        "device": str(runner.device), "scans": args.scans,
        "elapsed_s": round(elapsed, 3),
        "scans_per_sec": round(args.scans / elapsed, 3),
        "ate_rmse_m": round(float(ate), 5),
        "keyframes": int(runner.state.store.count),
        "loops": int(runner.state.loop_count),
        "full_corrections": len(runner.full_correction_scans),
        "mapping_error": runner.mapping_error}))


def main():
    ap = argparse.ArgumentParser(
        description="lio_slam_tpu_torch mission runner (PyTorch port). "
                    "The keyframe archive is not ported yet: the preset's "
                    "loop.archive_enabled is turned off with "
                    "dataclasses.replace.")
    ap.add_argument("--synthetic", action="store_true",
                    help="run the synthetic mission (the only input so far)")
    ap.add_argument("--scans", type=int, default=40)
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preset", default="default")
    ap.add_argument("--loop-every", type=int, default=10,
                    help="run the loop detector every N processed scans")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    if not args.synthetic:
        ap.error("pass --synthetic; bag replay is not ported yet")
    _run_synthetic(args)


if __name__ == "__main__":
    main()
