#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lio_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile-dir DIR]

1. Builds the port's CUDA kernel library from the sources in this checkout
   (nvcc, sm_90a) and prints the build time and ptxas's register report
   for each instantiation of the kernel (1, 3, 9 and 27 bucket ids a
   point).
2. Kernel phase: at the main path's shapes (an 8192-point scan against a
   65536-point map in a 32768 x 24 bucket grid, halo "z") holds the fused
   correspondence kernel to its plain PyTorch version on the card — inlier
   count exact, AtA / Atb within rtol 2e-4 / atol 2e-3, the sums within
   rtol 1e-4 — at refresh 1, with held bucket ids, on an empty map and on a
   half-masked scan, checks that repeated launches are bit-identical, and
   times kernel and plain version: device time per call from torch.profiler
   (the JSON line's ms / plain_ms) and per-call time from CUDA events.
   The kernel is also held to the plain version on a scan with a few
   non-finite points, timed once with a cold L2 (a 64 MB buffer written
   between launches, as the first GN iteration after a grid insert finds
   it), and against its bound: the bytes this run's inputs and outputs hold
   (distinct buckets touched x row bytes, ids, scan, mask, pose, outputs)
   over 3.35 TB/s, or its operations over 67 TFLOP/s, whichever is larger.
   `fused_normal_equations` (bucket ids at the pose, then the sums) is timed
   the same way beside its plain version `fused_normal_equations_ref`.
3. Mission phase: drives `Runner(device="cuda")` over the 40-scan synthetic
   mission at bench.py's shapes (loop closure off) and checks finite poses,
   ATE against truth, that the GN loop went through the kernel (launch count
   == sum of GN iterations), and the deviation from the JAX reference run
   recorded in lio_slam_tpu_torch/fixtures/smoke_mission_jax.npz (<= 0.02 m,
   <= 0.1 deg, same keyframe count).
4. Carried phase: the mission again, each scan starting from the reference
   run's IMU front-end state (recorded in the fixture): the same keyframe
   flags, GN iterations within one per scan, poses within 1e-3 m and
   0.005 deg.  This holds the mapping path alone to the reference; the
   free run also carries the reference's float32 error in its first IMU
   covariance update.
5. Profiled phase: scans 10-19 of a fresh run under torch.profiler: device
   busy time against the wall time of the same scans (idle share), and each
   runner stage's device time from its record_function range;
   `--profile-dir` also writes the profiler's table there.

6. Loop-mission phase: `Runner(cfg)` (the card is its default device) over
   the 125-scan closed circle with loop closure and GPS on
   (`synthetic_mission.loop_mission_config`), the loop detector every 10
   scans.  Fails unless loop and GPS factors were added in the numbers of
   the JAX reference run (lio_slam_tpu_torch/fixtures/loop_mission_jax.npz),
   a full correction ran with its map rebuild, the kernel's launches equal
   the GN iterations of mapping plus those of loop verification (counted
   apart, cycle by cycle), the trajectory stays within the stated distances
   of the reference run (the mapping limits before the first full
   correction, looser measured ones after) and the ATE against truth under
   its limit.  Prints each event's time, then times one full correction and
   one detector cycle on the final state under torch.profiler.
7. Verification-kernel check: the kernel against its plain version on a
   submap grid of that mission built in one shot by `build_grid`, with a
   keyframe cloud as the scan (the shapes loop verification launches it at).
8. Solver check: `solve_sparse` against the dense `solve` on the mission's
   final graph, and the time of a 5-iteration solve at K=256 and K=2048.
9. Archive-mission phase: `Runner(archive_mission_config(), loop_every=10,
   fetch_every=2, mission_log, auto_checkpoint, checkpoint_every=50)`, the
   loop mission with a 16-keyframe store and the keyframe archive on,
   against fixtures/archive_mission_jax.npz: evictions, archived keyframes
   and archive loops (at least one), loop / GPS / anchor / keyframe counts,
   the scans of the full corrections, the trajectory within the loop
   mission's limits, the mission log's `archive` events (as many as the
   archive loops, query newer than match).  Kernel launches of mapping, of
   loop verification and of archive verification are counted apart; ms
   per archive attempt with and without a verification, per checkpoint
   save and load.  Then the kernel as archive verification launches it (a
   grid over the archived submap, an archived keyframe as the scan) against
   its plain version.
10. Products and relocalization on that final state: local planning map,
   height map, normals and slope, obstacle SDF and save_map, ms each, the
   SOR-kept points, occupied height cells and saved map points within
   0.5 % of the reference's; three first-lap scans relocalized: success,
   the reference's keyframe, pose within 0.02 m / 0.1 deg of its pose,
   launches equal to the GN iterations.
11. Resume phase: the 40-scan mission (loop closure and GPS off) saved at
   scan 20, `Runner.resume` on the card over scans 20-39: poses within
   1e-6 of the uninterrupted run's (the same bits are expected).
12. Bag mission: the port's `write_synthetic_bag` writes the 125-scan bag
   of `synthetic_mission.bag_mission_bag_kwargs()` (the loop mission's
   circle as a 10 Hz lidar of 32768 points sees it: epoch stamps, in-sweep
   skew, 100 Hz 9-axis IMU, NavSatFix with covariances, the raw
   GpswithHeading stream); its sha256 must be the one the JAX reference run
   replayed (lio_slam_tpu_torch/fixtures/bag_mission_jax.npz).  `replay_bag`
   feeds it through the native sample queues (`use_native=True`: a host
   runtime that does not build fails the run) into `Runner(
   loop_mission_config(), loop_every=10, record_bag=...)` on the card.
   Fails unless every scan yields a result, the keyframe, loop and GPS
   factor counts and the scans of the full corrections equal the
   reference's, the trajectory keeps within the loop mission's limits, the
   ATE against the rebased truth is under its limit, the kernel's launches
   equal the GN iterations of mapping plus loop verification (counted
   apart), and the recorded bag holds one odometry record a scan at the
   trajectory's positions and the reference's gpsdata /
   sensor_fusion_output records.  Prints scans/s over the replay and host
   ms a scan in the cloud decode, the feed's windowing and process_scan,
   and holds the kernel to its plain version on the arguments of one of
   its launches there.
13. Hostile bag: 40 scans of `hostile_bag_kwargs()` (bz2 chunks, the
   Robosense layout, write-order jitter, duplicated IMU messages, an IMU
   dropout, GPS at 100 Hz) through `Runner(hostile_bag_config())`, held to
   the fixture's second run: scan count, keyframe flags, GPS factors, the
   trajectory within the mapping limits before the first GPS factor and
   the loop mission's after it, launches equal to the GN iterations, the
   kernel against its plain version on one of its launches.
14. Corner mission: `Runner(corner_mission_config())` on the card, the LOAM
   corner term on the incremental map at bench.py's widths (2048 corners a
   scan and a keyframe, a 16384-point corner map), over 60 scans of
   `make_sweep_sequence` through `rig_sensor_for(cfg)` (16 beams, 1800
   azimuth bins, 32768 points, rings and point times) with IMU windows
   covering each sweep.  Held to lio_slam_tpu_torch/fixtures/
   corner_mission_jax.npz (the JAX Runner over the same scans, their
   sha256 checked first): the trajectory within the mapping limits, the
   keyframe count, the corners stored per keyframe within 1 %, launches
   equal to the GN iterations, one captured launch against the plain
   version (the bag paths' rule).  Prints scans/s, the ATE beside the
   reference's, and host and device ms a scan of the corner extraction and
   the corner term (device time from a profiled pass over scans 20-24).
15. Rebuild mission: the same scans, 40 of them, with
   `local_map_mode="rebuild"`: the local and corner maps assembled from the
   nearby keyframes and a grid built every scan, `register_loam`; held to
   fixtures/rebuild_mission_jax.npz the same way, with the map assembly's
   and the grid build's times.
16. Hard-tier replay: `HostDrivenReplay(hard_replay_config(),
   loop_every=10)` (the "default" preset at bench.py's widths, its 500 Hz
   IMU in a 64-sample window) on the card over 60 sweep scans of the hard
   world (`hard_replay_inputs()`: 2 % garbage returns, 20000 clutter
   points), held to fixtures/hard_replay_jax.npz (the JAX replay of the
   same inputs, their sha256 checked first): every scan's degenerate flag
   and its GN iterations within one of the reference's, the trajectory
   within the mapping limits, the loop count, launches of mapping equal to
   the GN iterations and of loop verification counted apart, one captured
   launch against the plain version; then the replay again with the
   reference's IMU front-end state carried into each scan, within 1e-3 m
   and 0.005 deg.  Prints the ATE and mean GN iterations beside RIG_ATE.json's
   "default" row, scans/s over scans 5-59, and from a profiled replay of
   scans 20-24 the host and device ms a scan of prep+predict, the mapping
   step and correct+fuse with the device's idle share.
17. Deskew mission: the sweep mission of tests/test_sweep_sensor.py through
   `HostDrivenReplay` on the card with the point times and with zeros: the
   deskewed ATE under 0.2 m and within 10 % of the reference's, the ATE
   without deskew at least 4.5 times larger; launches of both runs.
Then both preintegration forms on one front-end window on the card: the
parallel form held to the sequential one, host and device ms and operator
calls of each; phases 3-5 also print the IMU front-end's host and device
ms a scan beside those of the sequential form.
18. Sharded mission (`lio_slam_tpu_torch/parallel/`), spawned (start
   method `spawn`) twice on cuda:0: world 1 on NCCL and world 2 on gloo
   (NCCL refuses two ranks on one card), each rank a process that joins
   through `parallel.distributed.initialize` from the LIO_* variables (a
   TCP store served by rank 0 on a free port, spawned once more on a fresh
   port only when a rank reports the address in use), under a deadline; a
   rank's failure or the deadline fails the run.  Each world runs (a) the
   column-sharded sparse solver at
   K=2048 against `solve_sparse` (the JAX slow test's gates: chain-only
   within 1e-4; with loops within 5e-2 and no farther from the truth than
   1.1x + 1e-3); (b) the map-sharded register on the kernel phase's scan
   and map, within 5e-3 of the single-device register; (c) `Runner(
   sharded_mission_config(D), device="cuda:0", mesh=...)` over 40 scans of
   the smoke sequence, an injected loop (newest keyframe to keyframe 0)
   and scans until its correction, held to
   lio_slam_tpu_torch/fixtures/sharded_mission_jax.npz (the JAX Runner on
   a mesh of 1 and 2 devices): within 0.02 m / 0.1 deg before the
   correction and 0.05 m / 0.25 deg after, keyframes and the correction's
   scan equal, rows a shard within 0.5 %, every replicated leaf bit-equal
   across ranks, no fused_corr launch (the sharded mapping path is plain
   k-NN with a cross-rank merge, as in JAX).  Prints scans/s over scans
   5-39, the mapping step's host and device ms a scan and the collectives'
   calls and ms a scan (torch.profiler over scans 40-41), the correction's
   ms and the solver's.  (d) The two-level mesh
   (`parallel/multislice.py`) on `distributed.global_mesh(
   devices_per_slice=1)`, one slice a process, (1, 1) and (2, 1):
   `make_multislice_solver` at K=2048 under (a)'s gates against
   `solve_sparse`; `make_multislice_register` on (b)'s scene (the scan
   placed by `distributed.factor_sharded`, the map by `replicated`, a grid
   of 32768 buckets x 24 on every rank) within 5e-3 of the single-device
   register and 0.02 of the truth; `psum_staged` against one all_reduce
   over the whole group on an integer-valued float32 tensor, bit-equal;
   no fused_corr launch in (d).  Prints the solver's and the register's
   ms, the register's iterations and its collective calls and ms
   (torch.profiler over one call), and the ms of the staged reduction
   against the flat one.
19. Device-resident replay programs (`pipeline/replay.py`), each scan two
   captured CUDA graphs: (a) bench.py part 1b's inputs (`bench_config()`,
   120 scans of 32768 points, 64-sample IMU windows) through
   `make_pipeline_replay(loop_every=10)` and through `HostDrivenReplay` in
   the same process: GN iterations and degenerate flags equal to the
   host-driven replay's, poses within 1e-5 m of them (the same bits are
   expected); against fixtures/pipeline_replay_jax.npz (the JAX monolith
   on the same inputs, their sha256 checked first) poses within 0.02 m /
   0.1 deg, the degenerate flags equal, the drift under bench.py's 3 m;
   then the graphs again with the reference's IMU front-end state carried
   into each scan, as phase 4 holds the mission: GN iterations as phase 16
   holds them, with both packages' GN traces printed at each scan that
   differs (the port's from the eager replay carried the same way, which
   must give the graphs' iterations and poses; the reference's from the
   fixture), poses within 0.02 m / 0.1 deg; the kernel on the
   arguments of one launch tapped inside graph (a)
   against its plain version (phase 12's tolerances with the float64
   arbiter), and graph (a)'s own results of that launch too.  (b) The loop
   mission's circle (`loop_mission_config()`, 130 scans, no GPS in a
   replay) through `ChunkedReplay(loop_every=10)`, held to
   fixtures/loop_replay_jax.npz (the JAX `ChunkedReplay`): the loop count
   after each chunk and the scans of the full corrections equal, poses
   within 0.05 m / 0.25 deg up to the first correction and 0.5 m / 2 deg
   after.  Both replays run under `torch.cuda.set_sync_debug_mode("error")`,
   off only inside the cadence calls (the detector and the full
   correction): a synchronization elsewhere fails the phase.  The kernel
   launches counted over each timed run (a graph's count at each of its
   replays) must be 30 a scan plus the loop verifications' GN iterations.
   Prints the capture time, scans/s over scans 5-119 of the graphs and of
   the host-driven replay, from a profiled 5-scan chunk the device ms a
   scan, the idle share and the fused_corr launches a scan (30 by
   design, counted and in the profile), and what the dead GN passes and
   the masked keyframe saves cost a scan (the mapping step captured alone
   at 30 passes and at the mean rounded up; with the keyframe gate forced
   down, with and without the save).
20. The grid's gather layouts, at bench.py's widths: (a), run right after
   phase 2 (torch.profiler keeps every record there; after phase 19 it
   drops most of them), the kernel at the instantiations phase 2 does not
   reach, on phase 2's scan and map in
   grids of 32768 buckets: halo "xy" at a cap of 72 (3 bucket ids a
   point), "full" at 128 (1), "none" at 24 (27), and "z" at 24 on the scan
   sorted by cell (`registration._cell_sorted`), each with the grid's
   counts as the main path passes them; each held to the plain version as
   phase 12 holds a launch (the float64 arbiter on entries that cancel),
   repeated launches bit-identical, at 1 and 3 ids bit-equal to the launch
   on whole rows (`counts=None`), device ms warm and with a cold L2 (and on
   whole rows), per-call ms, the plain version's device ms, the launch
   floor (`lio_fused_corr_floor`: the same launch running only the fixed
   chain of pose, ids, partials, ticket and the last block's sum) warm and
   cold, the slots filled against rows x C, and the bound from the filled
   slots beside the whole-row bound (phase 2 prints the floor and both
   bounds at z/24 too).  (b) The
   40-scan mission through `Runner(device="cuda")` under each of
   `synthetic_mission.LAYOUT_MISSIONS` ("xy"/72, "full"/128, "none"/24,
   and "z"/24 with `sort_scan_by_cell=True` and `scan_downsample="hash"`),
   held to fixtures/layout_missions_jax.npz (the JAX Runner of the same
   configs): launches equal to the GN iterations, within 0.02 m / 0.1 deg,
   the keyframe count, the ATE within 10 % of the reference's; then with
   the reference's IMU state carried in, GN iterations within 1 a scan.
   Prints scans/s over scans 5-39 of each beside phase 3's.  (c) 20 scans
   of `make_pipeline_replay` under the
   sorted, hash-downsampled config, then under "xy"/72 and "full"/128
   (their captured launches read the state grid's own counts): each
   bit-equal to `HostDrivenReplay` in the same process, no synchronization
   under "error" mode (the argsort and the downsample's scatter capture),
   the launches 30 a scan.  (a) prints each instantiation's warps a block
   beside its times.
21. The resident replays at the other configs the JAX scan programs run:
   (a) the first 40 scans of phase 19's inputs at `rebuild_replay_config()`
   (the rebuild-mode map, a local map of 131072 points assembled and its
   grid built inside graph (a) every scan) through
   `make_pipeline_replay(loop_every=10)` and `HostDrivenReplay` in the same
   process: bit-equal, no synchronization under "error" mode, launches 30
   a scan plus the loop verifications'; against the JAX monolith
   (fixtures/pipeline_replay_jax.npz, keys `rebuild_`, sha256 checked
   first) within 0.02 m / 0.1 deg with equal degenerate flags and
   keyframes, and with the reference's IMU state carried in, GN iterations
   within 1 a scan; the kernel on one launch tapped inside graph (a)
   against its plain version; scans/s of the graphs and of the host-driven
   replay, the capture time, and from a profiled chunk (scans 20-24) the
   device ms a scan and the idle share.  (b) The first 10 scans under the
   corner config (`corner_mission_config()`) and under `bench_config()`
   as graphs: bit for bit (a replay feeds no corner cloud, so the corner
   config takes the surface path, as in JAX), launches 30 a scan each.
22. The GN step's kernel (`ops/csrc/gn_small.cu`), run right after phase
   20 (a): both instantiations (solve; solve and eigensolve) on CUDA
   tensors against `smallmat.cholesky_solve(eps=1e-6)` and
   `smallmat.eigh_jacobi` on the same tensors, word for word, on the GN
   systems of phase 2's scene (the scan, the half-masked scan, the empty
   map's zeros, the scan's system with one direction unobserved); on the
   scan's system each instantiation's device ms a launch and the launch
   floor's (`lio_gn_small_floor`: the same launch moving its 42 words, no
   arithmetic), each as a launch inside a CUDA graph, a call through the
   wrapper, the latency bound (the dependent chain at the SM clock, the
   latencies estimated), and the plain version's host ms a call, device ms,
   device operations and ms as a graph.
23. The keyframe save's window-system kernel (`ops/csrc/window_system.cu`),
   run right after phase 22, at the main path's shapes (the default
   preset's K = 2048, B = 2175, G = 520, W = 64; `window_graph`: stores of
   2048, 1500 and 40 keyframes round the drive's circuit, with loops, stale
   slots and GPS factors in and out of the window): H and b against the
   plain version on the same card tensors, blockwise within the tests'
   bounds (WINDOW_H_RTOL / WINDOW_B_RTOL), a second launch the same bits,
   H symmetric; on the 1500-keyframe store the device ms a launch, in a
   CUDA graph and through the wrapper, the bytes bound, and the plain
   version's host ms a call, device ms and operations.
Every path above zeroes the kernels' launch counters and a count of the
keyframe saves (`lio._save_keyframe`'s calls outside a capture) before its
run: gn_small must launch once a GN pass (the fused kernel's launches, or
the sharded paths' GN iterations) and with the eigensolve once a
registration (exactly, where the run registers only its scans);
window_system twice a keyframe save, a scan replayed as a CUDA graph
counting as one (the resident step saves on every scan), checked on every
path and failed on after the last phase.
Each phase prints its wall time.

Prints the card's name and power limit, one JSON line describing the
kernels: fused_corr (its launches on every path driven, apart; a `layouts`
object with each instantiation's offsets, cap, times, bound and error) and
gn_small (its launches and those with the eigensolve on every path, apart,
and phase 22's times) and window_system (its launches and the keyframe
saves on every path, apart, and phase 23's gaps and times), and last
`{"ok": true, "device": {...}}`.  Exits
non-zero, without that line, if there is no CUDA device or any check
fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N_SCAN = 8192
N_MAP = 65536
TABLE, CAP = 32768, 24
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
FP32_FLOP_PER_S = 67e12       # H100 SXM, float32 outside the tensor cores
L2_FLUSH_BYTES = 64 << 20     # more than the card's 50 MB of L2
MAX_DEV_M = 0.02
MAX_DEV_RAD = math.radians(0.1)
# with the reference's IMU state carried in (CPU: 1.5e-4 m, 2.4e-4 deg, one
# scan one GN iteration apart)
CARRIED_MAX_DEV_M = 1e-3
CARRIED_MAX_DEV_RAD = math.radians(0.005)
CARRIED_MAX_ITER_DIFF = 1
# the loop mission against its JAX reference run: the 40-scan mission's
# limits until the first full correction; then every GPS factor's
# correction moves the map a little differently in float32, and a loop
# verified from a slightly different pose moves everything after it
LOOP_GPS_MAX_DEV_M = 0.05
LOOP_GPS_MAX_DEV_RAD = math.radians(0.25)
LOOP_MAX_DEV_M = 0.5
LOOP_MAX_DEV_RAD = math.radians(2.0)
LOOP_MAX_ATE_M = 1.0
SMI = "card not read"       # nvidia-smi's name and power limit, set by main
# The GN step's kernel (gn_small.cu) is bound by the latency of its chain of
# dependent operations, not by bytes or FLOP.  Its chain: the solve's 6
# roots, 17 divisions and about 45 dependent adds and multiplies, then on a
# first pass 8 x 15 Jacobi rotations of 2 roots, 3 divisions and about 15
# each.  Latencies on Hopper in SM clock cycles (estimated, not measured):
# an IEEE float32 root, an IEEE division, a dependent add or multiply.
SM_CLOCK_HZ = 1.98e9          # H100 SXM, boost clock, published
SQRT_CYCLES, DIV_CYCLES, FP_CYCLES = 40, 45, 4
GN_SOLVE_CHAIN = (6, 17, 45)  # roots, divisions, adds and multiplies
GN_ROTATION_CHAIN = (2, 3, 15)
GN_ROTATIONS = 8 * 15
# gn_small's launches on each path driven, apart: path -> (launches, of them
# with the eigensolve), each counted over the run that counts fused_corr's
GN_PATHS = {}
# window_system's launches on each path driven, apart: path -> (launches,
# keyframe saves); SAVES[0] counts `lio._save_keyframe`'s calls outside a
# capture since `zero_launches`, WS_FAULTS each path whose launches are not
# two a save (the run fails on them after its last phase)
WS_PATHS = {}
SAVES = [0]
WS_FAULTS = []
# the kernel launch of each bag and corner path whose arguments the kernel
# check reuses
BAG_CAPTURE_AT = 200
HOSTILE_CAPTURE_AT = 60
CORNER_CAPTURE_AT = {"incremental": 80, "rebuild": 70}
# the hard-tier replay's kernel launch held to the plain version
HARD_CAPTURE_AT = 100
# The hard replay's GN iterations may differ from the reference's by
# CARRIED_MAX_ITER_DIFF on a scan, their sums by no more than the scans
# that differ.  CPU (port and reference, each GN step read from its trace):
# free-running at 5 of 60 scans, where the JAX front-end's float32 first
# update moves the guesses and the first steps differ by up to 10 %; with
# the reference's front-end state carried in at 2, scan 59 a last step
# 0.04808 cm (reference, stops) against 0.05048 cm (port, goes on) at the
# 0.05 cm threshold, scan 58 a sixth step that doubles in the reference.
# the same stages with the sequential preintegration, before the front-end
# integrated in log depth (this script on an NVIDIA H100 80GB HBM3,
# 700.00 W): imu_frontend host and device ms a scan, device kernels and
# copies a scan
SEQUENTIAL_IMU_FRONTEND_MS = (83.593, 7.155)
SEQUENTIAL_DEVICE_KERNELS_A_SCAN = 15528
# RIG_ATE.json's "default" row, hard tier (the JAX package's record)
RIG_ATE_DEFAULT = (0.0653, 3.86)


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check_ne(name, got, ref):
    """The kernel contract; returns the largest AtA/Atb difference."""
    import numpy as np

    g = [x.detach().cpu().numpy() for x in got]
    r = [x.detach().cpu().numpy() for x in ref]
    if int(g[2]) != int(r[2]):
        fail(f"{name}: inliers {int(g[2])} != plain {int(r[2])}")
    for i, label in ((0, "AtA"), (1, "Atb")):
        if not np.allclose(g[i], r[i], rtol=2e-4, atol=2e-3):
            fail(f"{name}: {label} differs by {np.abs(g[i] - r[i]).max()}")
    for i, label in ((3, "sum s"), (4, "sum s|pd2|")):
        if not np.isclose(g[i], r[i], rtol=1e-4, atol=1e-4):
            fail(f"{name}: {label} {g[i]} != plain {r[i]}")
    err = max(float(np.abs(g[0] - r[0]).max()), float(np.abs(g[1] - r[1]).max()))
    scale = max(float(np.abs(r[0]).max()), float(np.abs(r[1]).max()), 1e-30)
    print(f"kernel check {name}: inliers {int(g[2])}, max |AtA,Atb diff| "
          f"{err:.3e} (largest |entry| {scale:.3e}, ratio {err / scale:.2e})",
          flush=True)
    return err


def call_ms(fn, reps=50, runs=5, warmup=5):
    """Per-call time as a caller sees it: CUDA events around a run of `reps`
    back-to-back calls, over the count; the median of `runs` such runs.
    Where the host enqueues more slowly than the device runs, this is the
    host's rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def device_busy_ms(averages) -> float:
    """Device time (kernels and copies) in a torch.profiler run's
    `key_averages()` (computed once by the caller: over a long trace it is
    the slow part); the device-side spans of record_function ranges are not
    work."""
    import torch

    return 1e-3 * sum(e.self_device_time_total for e in averages
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False))


def device_ms(fn, reps=20):
    """Device time per call: the durations of every kernel and copy `fn`
    puts on the card, summed by torch.profiler over `reps` calls.  Every
    call puts the same kernels there, so a kernel seen some other number of
    times than a multiple of `reps` means the tracer dropped records (late in
    a long process it drops most of the first call's).  Dropped records, up
    to 5% of a pass, are made good with that kernel's mean duration; with
    more the pass is made again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        full = [-(-e.count // reps) * reps for e in rows]
        lost = [f - e.count for f, e in zip(full, rows)]
        if rows and sum(lost) <= max(2, sum(full) // 20):
            if sum(lost):
                print(f"device_ms: {sum(lost)} dropped record(s) made good with "
                      "their kernel's mean duration", flush=True)
            return 1e-3 * sum(e.self_device_time_total / e.count * f
                              for f, e in zip(full, rows)) / reps
        print("device_ms: the profiler saw "
              f"{sorted(e.count for e in rows)} launches by kernel for {reps} "
              "calls; profiling again", flush=True)
    fail("the profiler lost device records in five passes")


def warm_profiler(dev):
    """The tracer reports nothing from the first profile of a process (it
    starts inside it): spend that one on a throwaway."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1024, device=dev)
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for _ in range(10):
                x = x + 1.0
            torch.cuda.synchronize()


def count_saves():
    """Wrap `lio._save_keyframe` (once a process) so that each call outside
    a CUDA graph's capture adds 1 to SAVES[0]: a keyframe save of the
    Runner's step, or a scan of the resident step run eagerly, which saves
    on every scan and selects the result."""
    import torch

    from lio_slam_tpu_torch.pipeline import lio

    save = lio._save_keyframe
    if getattr(save, "counted", False):
        return

    def counted(*a, **k):
        if not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            SAVES[0] += 1
        return save(*a, **k)
    counted.counted = True
    lio._save_keyframe = counted


def zero_launches():
    """The kernels' launch counters and the keyframe saves to 0, just
    before a path's run."""
    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.ops import gn_small as gs
    from lio_slam_tpu_torch.ops import window_system as ws

    count_saves()
    fc.KERNEL_LAUNCHES = 0
    gs.KERNEL_LAUNCHES = gs.EIGH_LAUNCHES = 0
    ws.KERNEL_LAUNCHES = SAVES[0] = 0


def gn_launches(path, passes, registrations=None, counts=None,
                graph_scans=0, ws_counts=None):
    """Add gn_small's launches since `zero_launches` (or `counts`, a rank's
    (launches, with the eigensolve)) to `GN_PATHS[path]`, and fail unless
    the GN step launched once a GN pass (`passes`: the fused kernel's
    launches over the same run, which the phase holds to the GN iterations,
    or the iterations where no fused kernel runs) and the eigensolve once a
    registration: `registrations` where the run holds none but the scans'
    own, else at least once where any pass ran and at most once a pass.
    Then `ws_launches(path, graph_scans, ws_counts)`."""
    from lio_slam_tpu_torch.ops import gn_small as gs

    ws_launches(path, graph_scans, ws_counts)

    n, e = counts if counts is not None else (gs.KERNEL_LAUNCHES,
                                              gs.EIGH_LAUNCHES)
    had = GN_PATHS.get(path, (0, 0))
    GN_PATHS[path] = (had[0] + n, had[1] + e)
    ok = (n == passes and e <= n and (e > 0) == (n > 0)
          and (registrations is None or e == registrations))
    print(f"{path}: gn_small launches {n} for {passes} GN passes, {e} with "
          f"the eigensolve for "
          f"{'the' if registrations is None else registrations} "
          "registrations", flush=True)
    if not ok:
        fail(f"{path}: gn_small launched {n} times ({e} with the eigensolve) "
             f"for {passes} GN passes and "
             f"{'its' if registrations is None else registrations} "
             "registrations")


def ws_launches(path, graph_scans=0, counts=None):
    """Add window_system's launches and the keyframe saves since
    `zero_launches` (or `counts`, a rank's (launches, saves)) to
    `WS_PATHS[path]`, and note a fault in WS_FAULTS unless the window solve
    launched twice a save: the eager saves (SAVES) plus `graph_scans`
    scans replayed as CUDA graphs, whose resident step saves on every
    scan."""
    from lio_slam_tpu_torch.ops import window_system as ws

    n, saves = counts if counts is not None else (ws.KERNEL_LAUNCHES,
                                                  SAVES[0])
    saves += graph_scans
    had = WS_PATHS.get(path, (0, 0))
    WS_PATHS[path] = (had[0] + n, had[1] + saves)
    print(f"{path}: window_system launches {n} for {saves} keyframe saves"
          + (f" ({graph_scans} of them scans of CUDA graphs)"
             if graph_scans else ""), flush=True)
    if n != 2 * saves:
        WS_FAULTS.append(f"{path}: window_system launched {n} times for "
                         f"{saves} keyframe saves")


def named_kernel_ms(fn, name_part, reps=20, between=None):
    """Device time per launch of the kernels whose name holds `name_part`,
    from torch.profiler; `between` runs before every call (not counted).
    The tracer may drop records, now and then all of a pass's: a pass that
    kept fewer than half of its `reps` launches is made again, as
    `device_ms` makes its passes again, five at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and name_part in e.key]
        seen = sum(e.count for e in rows)
        if reps // 2 <= seen <= reps:
            return 1e-3 * sum(e.self_device_time_total for e in rows) / seen
        print(f"named_kernel_ms: the profiler saw {seen} launches of "
              f"*{name_part}* for {reps} calls; profiling again", flush=True)
    fail(f"profiler saw {seen} launches of *{name_part}*, expected {reps}, "
         "in five passes")


def kernel_bound(table, hh, scan, mask, counts):
    """The least time the card could take for one call on these inputs, as
    a dict: `ms`, `by`, `bytes`, `flop`, `rows` (distinct bucket rows some
    unmasked point's ids name), `filled` (their filled slots, Σ counts[row]),
    `scanned` (the filled slots the unmasked points scan, a repeated id
    once), `point_slots` (the slots of those points' rows, C a row), and
    `whole_ms`, the bound PRs 1-12 stated (whole rows: rows x C slots),
    kept beside it so that ratios compare across PRs.  Bytes: the filled
    slots of each of those rows once (12 bytes a slot) and its count;
    ids, scan, mask and pose once; the 45 output words once.  Operations: 8
    a filled candidate distance, about 300 a plane fit, for the unmasked
    points.  The same count at every instantiation, whether or not the
    kernel reads `counts` (at 9 and 27 ids it ranks whole rows)."""
    import torch

    T, C, _ = table.shape
    ok = (hh >= 0) & (hh < T)
    live = hh[:, mask][ok[:, mask]]
    rows = torch.unique(live)
    n_rows = int(rows.numel())
    filled = int(counts[rows.long()].clamp(0, C).sum())
    fixed = hh.numel() * 4 + scan.numel() * 4 + mask.numel() + 6 * 4 + 45 * 4
    n_bytes = filled * 12 + n_rows * 4 + fixed
    whole_bytes = n_rows * C * 12 + fixed
    # the filled slots each unmasked point scans (a repeated id once)
    per_slot = torch.where(ok, counts[hh.clamp(0, T - 1).long()].clamp(0, C),
                           torch.zeros_like(hh))
    first = torch.ones_like(ok)
    for o in range(1, hh.shape[0]):
        first[o] = (hh[:o] != hh[o]).all(0)
    scanned = int((per_slot * first)[:, mask].sum())
    point_slots = int((ok & first)[:, mask].sum()) * C
    n_live = int(mask.sum())
    flop = scanned * 8 + n_live * 300
    whole_flop = n_live * (hh.shape[0] * C * 8 + 300)
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flop / FP32_FLOP_PER_S
    whole = max(1e3 * whole_bytes / HBM_BYTES_PER_S,
                1e3 * whole_flop / FP32_FLOP_PER_S)
    return {"ms": max(by_bytes, by_ops),
            "by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": n_bytes, "flop": flop, "rows": n_rows, "filled": filled,
            "slots": n_rows * C, "scanned": scanned,
            "point_slots": point_slots, "whole_ms": whole}


def floor_ms(table, hh, scan, mask, pose, between=None, **kw):
    """Device ms of the kernel's launch floor at these inputs: the same
    grid, block, dynamic shared memory and scratch as the kernel's launch,
    running the fixed chain alone (pose tables, point, mask bit and ids
    loaded, the partials written, the ticket, the last block's sum;
    `lio_fused_corr_floor`).  Its outputs are thrown away; it is no launch
    of the kernel and is not counted."""
    import torch

    from lio_slam_tpu_torch.ops import _build
    from lio_slam_tpu_torch.ops import fused_corr as fc

    lib = _build.load_fused_corr()
    dev = table.device
    scratch = fc.prepare_stream(dev)
    out = torch.empty(fc.OUT_WORDS, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = fc._kernel_args(table, hh, scan, mask, pose, kw["nn_radius"],
                           kw["plane_dist_thresh"], kw["robust_weight_floor"])

    def launch():
        err = lib.lio_fused_corr_floor(*args, scratch.data_ptr(),
                                       scratch.numel(), out.data_ptr(), stream)
        if err != 0:
            fail(f"the launch floor was refused: cudaError_t {err}")

    return named_kernel_ms(launch, "fused_corr_groups", between=between)


def scene_points():
    """(map (N_MAP, 3), body-frame scan (N_SCAN, 3), true pose): the
    synthetic world near the origin, the scan drawn from the map, seen from
    the pose, with sensor noise."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.utils import se3

    rs = np.random.RandomState(0)
    world = synthetic.make_world(0, extent=60.0)
    near = world[np.linalg.norm(world[:, :2], axis=1) < 45.0]
    map_pts = near[rs.permutation(len(near))[:N_MAP]]
    sel = rs.permutation(N_MAP)[:N_SCAN]
    pose0 = np.array([0.01, -0.02, 0.3, 1.0, -0.5, 0.2], np.float32)
    R0, t0 = se3.pose6_to_Rt(torch.from_numpy(pose0))
    body = ((torch.from_numpy(map_pts[sel]) - t0) @ R0).numpy()
    body = (body + rs.randn(N_SCAN, 3) * 0.02).astype(np.float32)
    return map_pts, body, pose0


def kernel_scene(dev, halo="z", cap=CAP):
    """(grid, scan, mask, pose, true pose) at the main path's shapes: an
    8192-point scan drawn from a 65536-point map in a 32768-bucket grid of
    `cap` slots under `halo` (32768 x 24 under "z"), and a pose a GN step
    away from the truth."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.ops import voxel_grid as vg

    map_pts, body, pose0 = scene_points()
    grid = vg.build_grid(torch.from_numpy(map_pts).to(dev),
                         torch.ones(N_MAP, dtype=torch.bool, device=dev),
                         1.0, TABLE, cap, halo=halo)
    scan = torch.from_numpy(body).to(dev)
    mask = torch.ones(N_SCAN, dtype=torch.bool, device=dev)
    pose = torch.from_numpy(pose0 + np.array([2e-3, -1e-3, 4e-3, 0.05, -0.04,
                                              0.02], np.float32)).to(dev)
    return grid, scan, mask, pose, torch.from_numpy(pose0).to(dev)


def kernel_phase(dev):
    import torch

    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.ops import voxel_grid as vg
    from lio_slam_tpu_torch.utils import se3

    grid, scan, mask, pose, pose_held = kernel_scene(dev)
    kw = dict(nn_radius=1.0, plane_dist_thresh=0.2, robust_weight_floor=0.1)
    print(f"kernel phase: scan {N_SCAN}, map {N_MAP} points in a {TABLE} x "
          f"{CAP} grid ({int(grid.counts.sum())} slots filled)", flush=True)

    errs = []
    out = fc.fused_normal_equations(grid, scan, mask, pose, **kw)
    torch.cuda.synchronize()
    errs.append(check_ne("refresh-1", out,
                         fc.fused_normal_equations_ref(grid, scan, mask, pose, **kw)))
    if int(out[2]) < N_SCAN // 4:
        fail(f"only {int(out[2])} inliers on a scan drawn from the map")
    again = fc.fused_normal_equations(grid, scan, mask, pose, **kw)
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        fail("repeated launches are not bit-identical")

    Rg, tg = se3.pose6_to_Rt(pose_held)
    hh = vg.bucket_ids(se3.transform_points(Rg, tg, scan), grid.cell_size, TABLE)
    held = fc.fused_ne_from_bucket_ids(grid.table, hh, scan, mask, pose, **kw)
    errs.append(check_ne("held-bucket-ids", held, fc.fused_ne_from_bucket_ids_ref(
        grid.table, hh, scan, mask, pose, **kw)))

    half = mask.clone()
    half[N_SCAN // 2:] = False
    errs.append(check_ne("half-masked", fc.fused_normal_equations(
        grid, scan, half, pose, **kw), fc.fused_normal_equations_ref(
        grid, scan, half, pose, **kw)))

    empty = vg.empty_grid(1.0, TABLE, CAP, device=dev)
    e = fc.fused_normal_equations(empty, scan, mask, pose, **kw)
    if int(e[2]) != 0 or float(e[0].abs().sum()) != 0.0 or \
            float(e[1].abs().sum()) != 0.0:
        fail("empty map gave a non-zero system")
    print("kernel check empty-map: zeros", flush=True)

    hh_now = vg.bucket_ids(se3.transform_points(*se3.pose6_to_Rt(pose), scan),
                           grid.cell_size, TABLE)
    kernel = lambda: fc.fused_ne_from_bucket_ids(grid.table, hh_now, scan, mask,
                                                 pose, **kw)
    plain = lambda: fc.fused_ne_from_bucket_ids_ref(grid.table, hh_now, scan,
                                                    mask, pose, **kw)
    # the entry point as the GN loop calls it at refresh 1 (bucket ids at the
    # pose, then the kernel), and its plain version on the same tensors
    entry_kernel = lambda: fc.fused_normal_equations(grid, scan, mask, pose, **kw)
    entry_plain = lambda: fc.fused_normal_equations_ref(grid, scan, mask, pose,
                                                        **kw)

    # a few non-finite points, masked and not: they contribute nothing, in
    # the kernel and in the plain version, on the same tensors
    bad = scan.clone()
    bad[7] = float("nan")
    bad[N_SCAN // 3, 1] = float("inf")
    bad[N_SCAN // 2] = float("nan")
    bad[N_SCAN - 1, 2] = float("-inf")
    bad_mask = mask.clone()
    bad_mask[N_SCAN // 2] = False
    bad_mask[N_SCAN - 1] = False
    nf = fc.fused_ne_from_bucket_ids(grid.table, hh_now, bad, bad_mask, pose, **kw)
    if not all(bool(torch.isfinite(x.float()).all()) for x in nf):
        fail("non-finite points reached the sums")
    errs.append(check_ne("non-finite-points", nf, fc.fused_ne_from_bucket_ids_ref(
        grid.table, hh_now, bad, bad_mask, pose, **kw)))
    if int(nf[2]) > int(out[2]):
        fail("the non-finite points were counted as inliers")

    # in turns on held bucket ids, L2-warm as inside the GN loop
    on_device = [device_ms(plain), device_ms(kernel), device_ms(kernel),
                 device_ms(plain)]
    per_call = [call_ms(plain, reps=10), call_ms(kernel), call_ms(kernel),
                call_ms(plain, reps=10)]
    entry_device = [device_ms(entry_plain), device_ms(entry_kernel),
                    device_ms(entry_kernel), device_ms(entry_plain)]
    entry_call = [call_ms(entry_plain, reps=10), call_ms(entry_kernel),
                  call_ms(entry_kernel), call_ms(entry_plain, reps=10)]
    # the kernel alone (without the wrapper's allocation), warm and with a
    # cold L2: a 64 MB buffer written before every launch
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    warm_ms = named_kernel_ms(kernel, "fused_corr_groups")
    cold_ms = named_kernel_ms(kernel, "fused_corr_groups",
                              between=lambda: flush.fill_(1.0))
    entry = {name: call_ms(lambda: fc.fused_normal_equations(g, scan, m, pose,
                                                             **kw))
             for name, g, m in (("full", grid, mask), ("half-masked", grid, half),
                                ("empty-map", empty, mask))}
    bound = kernel_bound(grid.table, hh_now, scan, mask, grid.counts)
    bound_ms, bound_by = bound["ms"], bound["by"]
    # the launch floor at the same launch shape, warm and with a cold L2
    floor = floor_ms(grid.table, hh_now, scan, mask, pose, **kw)
    floor_cold = floor_ms(grid.table, hh_now, scan, mask, pose, **kw,
                          between=lambda: flush.fill_(1.0))
    del flush
    fmt = lambda xs: ", ".join(f"{x:.4f}" for x in xs)
    print("kernel timing, device ms per call (torch.profiler): plain, "
          f"kernel, kernel, plain = {fmt(on_device)}", flush=True)
    print("kernel timing, ms per call as the caller sees it (CUDA events over "
          "back-to-back calls): plain, kernel, kernel, plain = "
          f"{fmt(per_call)}; bucket ids + kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in entry.items()), flush=True)
    print("fused_normal_equations (bucket ids at the pose + the sums), plain, "
          f"kernel, kernel, plain: device ms per call {fmt(entry_device)}; ms "
          f"per call as the caller sees it {fmt(entry_call)}", flush=True)
    ms = min(on_device[1:3])
    print(f"kernel alone (fused_corr_groups, torch.profiler): warm {warm_ms:.4f} "
          f"ms, cold L2 {cold_ms:.4f} ms", flush=True)
    print(f"kernel bound: {bound['rows']} distinct bucket rows, "
          f"{bound['filled']} slots filled of their {bound['slots']} "
          f"(rows x {CAP}), {bound['bytes']} bytes, {bound['flop']} FLOP -> "
          f"{bound_ms:.5f} ms by {bound_by} (whole rows: "
          f"{bound['whole_ms']:.5f} ms); time over bound: warm "
          f"{ms / bound_ms:.2f}, cold {cold_ms / bound_ms:.2f}", flush=True)
    print(f"launch floor z/{CAP} ({SMI}): warm {floor:.4f} ms, cold L2 "
          f"{floor_cold:.4f} ms, against the kernel's {warm_ms:.4f} / "
          f"{cold_ms:.4f}", flush=True)
    return {"max_abs_err": max(errs), "ms": ms,
            "plain_ms": min(on_device[0], on_device[3]), "cold_ms": cold_ms,
            "entry_ms": min(entry_device[1:3]),
            "entry_plain_ms": min(entry_device[0], entry_device[3]),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_whole_rows_ms": bound["whole_ms"], "floor_ms": floor,
            "floor_cold_ms": floor_cold, "slots_filled": bound["filled"],
            "slots_read": bound["slots"]}


def gn_chain_ms(eigh: bool) -> float:
    """The GN step's latency bound: ms of its dependent chain at the SM
    clock (the constants above)."""
    cycles = lambda roots, divs, fp: (roots * SQRT_CYCLES + divs * DIV_CYCLES
                                      + fp * FP_CYCLES)
    n = cycles(*GN_SOLVE_CHAIN)
    if eigh:
        n += GN_ROTATIONS * cycles(*GN_ROTATION_CHAIN)
    return 1e3 * n / SM_CLOCK_HZ


def gn_small_phase(dev):
    """Phase 22: the GN step's kernel (`ops/csrc/gn_small.cu`) on the GN
    systems of phase 2's scene as `_gn_pass` takes them (the scan, the
    half-masked scan, the empty map's zeros, and the scan's system with one
    direction unobserved), both instantiations word for word against
    `smallmat` on the same tensors; then on the scan's system the device
    ms a launch of each and of the launch floor (`lio_gn_small_floor`),
    ms a launch inside a CUDA graph, ms a call through the wrapper as the
    caller sees it, and the plain version's host ms a call, device ms,
    device operations and ms as a graph.  Returns the `kernels` entry's
    numbers."""
    import torch

    from lio_slam_tpu_torch.ops import _build
    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.ops import gn_small as gs
    from lio_slam_tpu_torch.ops import voxel_grid as vg
    from lio_slam_tpu_torch.utils import smallmat

    grid, scan, mask, pose, _ = kernel_scene(dev)
    kw = dict(nn_radius=1.0, plane_dist_thresh=0.2, robust_weight_floor=0.1)
    half = mask.clone()
    half[N_SCAN // 2:] = False
    empty = vg.empty_grid(1.0, TABLE, CAP, device=dev)
    systems = {name: fc.fused_normal_equations(g, scan, m, pose, **kw)[:2]
               for name, g, m in (("scan", grid, mask),
                                  ("half-masked", grid, half),
                                  ("empty-map", empty, mask))}
    A, b = systems["scan"]
    unobserved = A.clone()
    unobserved[5, :] = 0.0
    unobserved[:, 5] = 0.0
    systems["unobserved-direction"] = (unobserved, b)

    def plain(A, b, first):
        dx = smallmat.cholesky_solve(A, b, eps=gs.EPS)
        return (dx, *smallmat.eigh_jacobi(A)) if first else (dx,)

    for name, (A_, b_) in systems.items():
        ref = plain(A_, b_, True)
        got = (gs.solve(A_, b_), *gs.solve_eigh(A_, b_))
        same = [torch.equal(x.view(torch.int32), y.view(torch.int32))
                for x, y in zip(got, (ref[0], *ref))]
        print(f"gn_small {name}: solve, solve_eigh (dx, eigenvalues, "
              f"eigenvectors) word for word with smallmat {same}; "
              f"eigenvalues {[f'{x:.4g}' for x in got[2].tolist()]}",
              flush=True)
        if not all(same):
            fail(f"gn_small on the {name} system parts from smallmat {same}")

    lib = _build.load_fused_corr()
    out = torch.empty(gs.OUT_WORDS[True], dtype=torch.float32, device=dev)

    def raw(eigh):
        """A bare launch on the current stream: eigh True / False, or the
        floor (None)."""
        def launch():
            s = torch.cuda.current_stream().cuda_stream
            if eigh is None:
                err = lib.lio_gn_small_floor(A.data_ptr(), b.data_ptr(),
                                             out.data_ptr(), s)
            else:
                err = lib.lio_gn_small(A.data_ptr(), b.data_ptr(), int(eigh),
                                       out.data_ptr(), s)
            if err != 0:
                fail(f"a gn_small launch was refused: cudaError_t {err}")
        return launch

    res = {"max_abs_err": 0.0, "bound_by": "latency"}
    for key, eigh, name in (("", True, "gn_small<true>"),
                            ("solve_", False, "gn_small<false>"),
                            ("floor_", None, "gn_small_floor")):
        res[f"{key}ms"] = named_kernel_ms(raw(eigh), name, reps=50)
        res[f"{key}graph_ms"] = launch_graph_ms(raw(eigh))
    res["call_ms"] = call_ms(lambda: gs.solve_eigh(A, b))
    res["solve_call_ms"] = call_ms(lambda: gs.solve(A, b))
    res["bound_ms"], res["solve_bound_ms"] = gn_chain_ms(True), gn_chain_ms(False)
    for key, first in (("", True), ("solve_", False)):
        _, busy, n_dev, _ = profiled_once(lambda: plain(A, b, first))
        res[f"plain_{key}ms"] = busy
        res[f"plain_{key}ops"] = n_dev
        res[f"plain_{key}call_ms"] = call_ms(lambda: plain(A, b, first),
                                             reps=3, runs=3, warmup=1)
        res[f"plain_{key}graph_ms"] = graph_ms(lambda: plain(A, b, first))
    print(f"gn_small ({SMI}), device ms a launch (torch.profiler): first "
          f"pass {res['ms']:.5f}, solve {res['solve_ms']:.5f}, floor "
          f"{res['floor_ms']:.5f}; in a CUDA graph {res['graph_ms']:.5f} / "
          f"{res['solve_graph_ms']:.5f} / {res['floor_graph_ms']:.5f}; a "
          f"call through the wrapper {res['call_ms']:.5f} / "
          f"{res['solve_call_ms']:.5f}; latency bound {res['bound_ms']:.5f} "
          f"/ {res['solve_bound_ms']:.5f} (time over it "
          f"{res['ms'] / res['bound_ms']:.2f} / "
          f"{res['solve_ms'] / res['solve_bound_ms']:.2f})", flush=True)
    print(f"gn_small's plain version (smallmat as torch ops) on the card: "
          f"first pass {res['plain_call_ms']:.3f} ms a call, device "
          f"{res['plain_ms']:.3f} ms in {res['plain_ops']} operations, "
          f"{res['plain_graph_ms']:.3f} ms as a graph; solve "
          f"{res['plain_solve_call_ms']:.3f} ms, device "
          f"{res['plain_solve_ms']:.3f} ms in {res['plain_solve_ops']}, "
          f"{res['plain_solve_graph_ms']:.3f} ms as a graph", flush=True)
    return res


# ---- phase 23: the keyframe save's window system ----

# the tests' bounds on the kernel against the plain version
# (tests/torch_port_helpers.py WINDOW_H_RTOL, WINDOW_B_RTOL): every block of
# H and of b within these shares of its largest entry
WINDOW_H_RTOL = 5e-5
WINDOW_B_RTOL = 2e-5
# phase 23's stores: keyframes held (a full store; a drive's mid-run one;
# fewer than the window, the prior inside it)
WINDOW_COUNTS = (2048, 1500, 40)
WINDOW_LAP = 75           # keyframes a lap of the circuit, 1 m apart


def window_graph(dev, count):
    """(graph, count, W) of the window solve as the default preset holds
    it (`lio.init_state(Config())`: K = 2048 keyframes, B = K - 1 + 16 x 8
    between slots, G = 64 x 8 + 8 GPS slots, W = 64) after `count`
    keyframes laid 1 m apart round a circuit of radius 12 m, the drive's:
    odometry between consecutive keyframes, loop factors from the newest
    keyframes back to the same place a lap earlier (one end in the window)
    and 37 keyframes earlier (both ends in it, from the second lap on),
    four stale loop slots (mask off) inside the window, GPS factors on
    every fourth keyframe (two on the newest), the prior on keyframe 0;
    the preset's information (`window_case` in tests/torch_port_helpers.py),
    poses the truth plus seeded noise, measurements the truth's plus
    1e-3."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.config import Config
    from lio_slam_tpu_torch.graph import factors as F
    from lio_slam_tpu_torch.utils import se3

    cfg = Config()
    s = cfg.static
    K, W = s.max_keyframes, s.window_size
    B = K - 1 + s.max_loop_queue * 8
    G = s.max_gps_queue * 8 + s.max_archive_anchors
    rs = np.random.RandomState(count)
    k = np.arange(K)
    yaw = k * (2 * np.pi / WINDOW_LAP)
    truth = np.zeros((K, 6), np.float32)
    truth[:, 2] = yaw
    truth[:, 3] = 12.0 * np.sin(yaw)
    truth[:, 4] = 12.0 * (1.0 - np.cos(yaw))
    noise = rs.randn(K, 6) * [0.01, 0.01, 0.01, 0.05, 0.05, 0.05]
    poses = truth + (noise * (k < count)[:, None]).astype(np.float32)
    odom = [1e6, 1e6, 1e6, 1e4, 1e4, 1e4]
    loop = [1e3, 1e3, 1e3, 1e2, 1e2, 1e2]
    newest = range(count - 1, 0, -1)
    lap = [(j - WINDOW_LAP, j) for j in newest if j >= WINDOW_LAP][::5][:100]
    near = [(j - 37, j) for j in newest if j >= WINDOW_LAP][:8:2]
    pairs = [(i, i + 1, odom) for i in range(count - 1)]
    pairs += [(i, j, loop) for i, j in lap + near]
    bt_i, bt_j = np.zeros(B, np.int32), np.zeros(B, np.int32)
    bt_meas, bt_info = np.zeros((B, 6), np.float32), np.zeros((B, 6), np.float32)
    bt_mask = np.zeros(B, bool)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    for n, (i, j, info) in enumerate(pairs):
        slot = n if n < count - 1 else K - 1 + n - (count - 1)
        bt_i[slot], bt_j[slot] = i, j
        bt_meas[slot] = se3.pose6_between(t(truth[i]), t(truth[j])).numpy() \
            + rs.randn(6).astype(np.float32) * 1e-3
        bt_info[slot] = info
        bt_mask[slot] = True
    stale = K - 1 + len(lap) + len(near)
    for q in range(4):
        if count > 2:
            bt_i[stale + q] = max(count - 2 - q, 0)
            bt_j[stale + q] = count - 1 - q // 2
            bt_info[stale + q] = odom
    gps = list(range(count - 1, -1, -4))[:G - s.max_archive_anchors - 1]
    gps = gps[:1] + gps
    gps_i, gps_meas = np.zeros(G, np.int32), np.zeros((G, 3), np.float32)
    gps_info, gps_mask = np.zeros((G, 3), np.float32), np.zeros(G, bool)
    for n, i in enumerate(gps):
        gps_i[n] = i
        gps_meas[n] = truth[i, 3:] + rs.randn(3) * 0.1
        gps_info[n] = [1.0, 1.0, 0.5]
        gps_mask[n] = True
    on = lambda x: t(x).to(dev)
    graph = F.PoseGraph(
        poses=on(poses), pose_mask=on(k < count), prior_pose=on(truth[0]),
        prior_info=on(np.array([100, 100, 0.1, 1e-8, 1e-8, 1e-8],
                               np.float32)),
        bt_i=on(bt_i), bt_j=on(bt_j), bt_meas=on(bt_meas),
        bt_info=on(bt_info), bt_mask=on(bt_mask), gps_i=on(gps_i),
        gps_meas=on(gps_meas), gps_info=on(gps_info), gps_mask=on(gps_mask))
    return graph, torch.tensor(count, dtype=torch.int32, device=dev), W


def window_gaps(got, ref, W):
    """(H's, b's) largest blockwise gap of `got` from `ref` as a share of
    the block's largest entry in `ref`, and whether the zero blocks of H
    are the same."""
    import torch

    (Hg, bg), (Hr, br) = got, ref
    blocks = lambda H: H.reshape(W, 6, W, 6).permute(0, 2, 1, 3)
    scale = blocks(Hr).abs().amax((2, 3))
    zeros = torch.equal(blocks(Hg).abs().amax((2, 3)) == 0, scale == 0)
    gap = blocks(Hg - Hr).abs().amax((2, 3)) / scale.clamp(min=1e-30)
    bscale = br.reshape(W, 6).abs().amax(1)
    bgap = (bg - br).reshape(W, 6).abs().amax(1) / bscale.clamp(min=1e-30)
    return float(gap.max()), float(bgap.max()), zeros


def window_system_phase(dev):
    """Phase 23: the keyframe save's window-system kernel
    (`ops/csrc/window_system.cu`) at the main path's shapes
    (`window_graph`, each of WINDOW_COUNTS): H and b against the plain
    version (`solver.assemble_window_plain`) on the same card tensors,
    blockwise within WINDOW_H_RTOL / WINDOW_B_RTOL, both printed beside
    their gaps from the float64 plain version; H symmetric and a second
    launch the same bits.  Then on the drive's store (1500 keyframes) the
    device ms a launch, ms a launch inside a CUDA graph, ms a call through
    the wrapper, the bytes bound, and the plain version's host ms a call,
    device ms and device operations.  Returns the `kernels` entry's
    numbers."""
    import torch

    from lio_slam_tpu_torch.graph import factors as F
    from lio_slam_tpu_torch.graph import solver
    from lio_slam_tpu_torch.ops import window_system as ws

    res = {"max_h_gap": 0.0, "max_b_gap": 0.0}
    for count in WINDOW_COUNTS:
        graph, c, W = window_graph(dev, count)
        got = ws.assemble(graph, c, W)
        again = ws.assemble(graph, c, W)
        ref = solver.assemble_window_plain(graph, c, W)
        g64 = F.PoseGraph(*(x.double() if x.is_floating_point() else x
                            for x in graph))
        truth = solver.assemble_window_plain(g64, c, W)
        wide = lambda hb: (hb[0].double(), hb[1].double())
        h_gap, b_gap, zeros = window_gaps(got, ref, W)
        k64, p64 = window_gaps(wide(got), truth, W), \
            window_gaps(wide(ref), truth, W)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        sym = torch.equal(got[0], got[0].T)
        print(f"window_system, {count} keyframes (K {graph.poses.shape[0]}, "
              f"W {W}, B {graph.bt_i.shape[0]}, G {graph.gps_i.shape[0]}; "
              f"{int(graph.bt_mask.sum())} between and "
              f"{int(graph.gps_mask.sum())} GPS factors): H / b blockwise "
              f"{h_gap:.3e} / {b_gap:.3e} from the plain version (limits "
              f"{WINDOW_H_RTOL:g} / {WINDOW_B_RTOL:g}), zero blocks alike "
              f"{zeros}; from float64: kernel {k64[0]:.3e} / {k64[1]:.3e}, "
              f"plain {p64[0]:.3e} / {p64[1]:.3e}; a second launch the same "
              f"bits {same}, H symmetric {sym}", flush=True)
        if not (h_gap <= WINDOW_H_RTOL and b_gap <= WINDOW_B_RTOL and zeros
                and same and sym):
            fail(f"window_system at {count} keyframes parts from the plain "
                 f"version: H {h_gap:.3e}, b {b_gap:.3e}, zero blocks "
                 f"{zeros}, repeat {same}, symmetric {sym}")
        res["max_h_gap"] = max(res["max_h_gap"], h_gap)
        res["max_b_gap"] = max(res["max_b_gap"], b_gap)

    graph, c, W = window_graph(dev, 1500)
    B, G = graph.bt_i.shape[0], graph.gps_i.shape[0]
    launch = lambda: ws.assemble(graph, c, W)
    plain = lambda: solver.assemble_window_plain(graph, c, W)
    # the bytes no launch can skip: H and b written, every slot's indices
    # and mask read once
    n_bytes = 4 * (36 * W * W + 6 * W) + 9 * B + 5 * G
    res.update(ms=named_kernel_ms(launch, "window_system", reps=50),
               graph_ms=launch_graph_ms(launch), call_ms=call_ms(launch),
               bound_ms=1e3 * n_bytes / HBM_BYTES_PER_S,
               bound_by="hbm bytes (outputs, one read of the slot lists)")
    _, res["plain_ms"], res["plain_ops"], _ = profiled_once(plain)
    res["plain_call_ms"] = call_ms(plain, reps=3, runs=3, warmup=1)
    print(f"window_system ({SMI}), 1500 keyframes: device ms a launch "
          f"(torch.profiler) {res['ms']:.5f}, in a CUDA graph "
          f"{res['graph_ms']:.5f}, a call through the wrapper "
          f"{res['call_ms']:.5f}; bytes bound {res['bound_ms']:.5f} "
          f"({n_bytes} bytes); the plain version (jacfwd and scatters) "
          f"{res['plain_call_ms']:.3f} ms a call, device "
          f"{res['plain_ms']:.3f} ms in {res['plain_ops']} operations",
          flush=True)
    return res


def mission_phase(dev, profile_dir):
    import numpy as np
    import torch

    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm
    from lio_slam_tpu_torch.pipeline.runner import Runner

    fixture = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                                   "smoke_mission_jax.npz"))
    cfg = sm.bench_config()
    seq = synthetic.make_sequence(n_scans=sm.SMOKE_SCANS, n_points=sm.SMOKE_POINTS,
                                  seed=sm.SMOKE_SEED, speed=sm.SMOKE_SPEED)
    scans, imus = sm.synthetic_inputs(seq, cfg)
    runner = Runner(cfg, device=dev)

    zero_launches()
    results, stamps = [], []
    t0 = time.perf_counter()
    for i in range(len(scans)):
        results.append(runner.process_scan(scans[i], imu=imus[i]))
        stamps.append(time.perf_counter())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = fc.KERNEL_LAUNCHES
    gn_launches("mission", launches,
                sum(r.registration_iters > 0 for r in results))

    poses = np.stack([r.pose for r in results])
    if not np.isfinite(poses).all():
        fail("non-finite poses")
    iters = [r.registration_iters for r in results]
    if launches != sum(iters) or launches == 0:
        fail(f"kernel launches {launches} != GN iterations {sum(iters)}")
    ate = synthetic.ate_rmse(poses, sm.relative_truth(seq))
    dev_t = float(np.abs(poses[:, 3:] - fixture["poses"][:, 3:]).max())
    dev_r = float(np.abs(poses[:, :3] - fixture["poses"][:, :3]).max())
    kf = int(runner.state.store.count)
    kf_ref = int(fixture["keyframes"])
    is_kf = np.array([r.is_keyframe for r in results])
    steady = (len(scans) - 5) / (stamps[-1] - stamps[4])
    print(f"mission: {len(scans)} scans in {elapsed:.3f} s = "
          f"{len(scans) / elapsed:.3f} scans/s (scans 5-39: {steady:.3f} "
          f"scans/s); ATE {ate:.5f} m (JAX reference run {float(fixture['ate_rmse_m']):.5f} m)",
          flush=True)
    d_it = np.array(iters) - fixture["registration_iters"]
    print(f"mission: kernel launches {launches} == sum of GN iterations "
          f"{sum(iters)} (JAX reference {int(fixture['registration_iters'].sum())}, "
          f"differing at scans {np.nonzero(d_it)[0].tolist()}); "
          f"keyframes {kf} (JAX {kf_ref}); keyframe flags differ at scans "
          f"{np.nonzero(is_kf != fixture['is_keyframe'])[0].tolist()}", flush=True)
    print(f"mission: max deviation from the JAX reference {dev_t:.3e} m, "
          f"{math.degrees(dev_r):.3e} deg; mapping_error {runner.mapping_error}",
          flush=True)
    if not np.isfinite(ate) or ate > 0.05:
        fail(f"ATE {ate} m against truth")
    if dev_t > MAX_DEV_M or dev_r > MAX_DEV_RAD:
        fail(f"deviation from the JAX reference {dev_t} m / {dev_r} rad")
    if kf != kf_ref:
        fail(f"{kf} keyframes, JAX reference {kf_ref}")
    if runner.mapping_error:
        fail("IMU front-end reported a mapping error")
    host = {k: round(v["mean_ms"], 3) for k, v in runner.timer.as_dict().items()}
    print(f"mission stages, host ms/scan (unsynchronized): {json.dumps(host)}",
          flush=True)
    print(f"mission: imu_frontend (preintegrate_parallel) {host['imu_frontend']} "
          f"host ms/scan; sequential: {SEQUENTIAL_IMU_FRONTEND_MS[0]} ({SMI})",
          flush=True)

    carried_phase(dev, cfg, scans, imus, fixture)
    profiled_phase(dev, cfg, scans, imus, profile_dir)
    return launches, steady


def fixture_imu_state(fixture, i, dev):
    """The JAX front-end's state at the start of scan i, on `dev`."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.ops import preintegration as pre
    from lio_slam_tpu_torch.pipeline import imu_frontend as fe

    get = lambda k: torch.from_numpy(np.array(fixture[k][i])).to(dev)
    return fe.ImuFrontendState(
        nav=pre.NavState(R=get("imu_R"), p=get("imu_p"), v=get("imu_v")),
        bias_gyr=get("imu_bias_gyr"), bias_acc=get("imu_bias_acc"),
        cov=get("imu_cov"), initialized=get("imu_initialized"),
        failure=get("imu_failure"))


def carried_phase(dev, cfg, scans, imus, fixture):
    """The mission again, each scan starting from the JAX front-end's state:
    the mapping path alone against the reference, without the reference's
    float32 error in its first covariance update."""
    import numpy as np

    from lio_slam_tpu_torch.pipeline.runner import Runner

    runner = Runner(cfg, device=dev)
    results = []
    for i in range(len(scans)):
        runner.imu_state = fixture_imu_state(fixture, i, dev)
        results.append(runner.process_scan(scans[i], imu=imus[i]))
    poses = np.stack([r.pose for r in results])
    dev_t = float(np.abs(poses[:, 3:] - fixture["poses"][:, 3:]).max())
    dev_r = float(np.abs(poses[:, :3] - fixture["poses"][:, :3]).max())
    d_it = np.array([r.registration_iters for r in results]) \
        - fixture["registration_iters"]
    is_kf = np.array([r.is_keyframe for r in results])
    print(f"carried IMU state: max deviation {dev_t:.3e} m, "
          f"{math.degrees(dev_r):.3e} deg; GN iterations {int(d_it.sum()):+d} "
          f"against the reference, differing at scans "
          f"{np.nonzero(d_it)[0].tolist()}; keyframe flags differ at scans "
          f"{np.nonzero(is_kf != fixture['is_keyframe'])[0].tolist()}",
          flush=True)
    if (is_kf != fixture["is_keyframe"]).any():
        fail("keyframe flags differ from the reference with its IMU state")
    if np.abs(d_it).max() > CARRIED_MAX_ITER_DIFF:
        fail(f"GN iterations differ by up to {np.abs(d_it).max()} on a scan")
    if dev_t > CARRIED_MAX_DEV_M or dev_r > CARRIED_MAX_DEV_RAD:
        fail(f"carried-state deviation {dev_t} m / {dev_r} rad")


def profiled_phase(dev, cfg, scans, imus, profile_dir):
    """Scans 10-19 of a fresh run under torch.profiler: device busy time
    against the wall time of the same scans, and each stage's device time
    from its record_function range."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lio_slam_tpu_torch.pipeline.runner import Runner
    from lio_slam_tpu_torch.utils.profiling import STAGES

    runner = Runner(cfg, device=dev)
    for i in range(10):
        runner.process_scan(scans[i], imu=imus[i])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(10, 20):
            runner.process_scan(scans[i], imu=imus[i])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = prof.key_averages()
    busy_ms = device_busy_ms(rows)
    cuda = torch.autograd.DeviceType.CUDA
    n_dev = sum(e.count for e in rows if e.device_type == cuda
                and not getattr(e, "is_user_annotation", False))
    stages = {e.key: {"device_ms": round(1e-3 * e.device_time_total / e.count, 3),
                      "host_ms": round(1e-3 * e.cpu_time_total / e.count, 3)}
              for e in rows if e.key in STAGES and e.device_type != cuda}
    print(f"profiled scans 10-19: device busy {busy_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall time in the same pass (idle share "
          f"{1.0 - busy_ms / wall_ms:.3f}); {n_dev} device kernels and "
          f"copies, {n_dev / 10:.1f} per scan, {1e3 * wall_ms / max(n_dev, 1):.2f} us "
          "of wall time each", flush=True)
    print(f"profiled stages, ms/scan (device: kernels launched inside the "
          f"stage; host: the range under the profiler): {json.dumps(stages)}",
          flush=True)
    front = stages.get("imu_frontend", {})
    print(f"profiled: imu_frontend {front.get('device_ms')} device ms/scan, "
          f"{front.get('host_ms')} host ms/scan under the profiler "
          f"(sequential: {SEQUENTIAL_IMU_FRONTEND_MS[1]} device ms/scan); "
          f"{n_dev / 10:.1f} device kernels and copies a scan (sequential: "
          f"{SEQUENTIAL_DEVICE_KERNELS_A_SCAN}) "
          f"({SMI})", flush=True)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        with open(os.path.join(profile_dir, "mission_profile.txt"), "w") as f:
            f.write(rows.table(sort_by="cuda_time_total", row_limit=40))
        print(f"profile table written to {profile_dir}", flush=True)


def synced_ms(fn):
    """(result, ms): `fn()` between two device synchronizations, on the
    host's clock: the host's work and the device's, whichever ends last."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def profiled_once(fn):
    """(result, device busy ms, device kernels and copies, wall ms) of one
    call under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = prof.key_averages()
    n_dev = sum(e.count for e in rows
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))
    return out, device_busy_ms(rows), n_dev, wall_ms


def lever_graph(K, n_loops, dev):
    """A graph at capacity K with every pose active: a noisy straight chain
    of 1 m steps, `n_loops` loop factors i <-> i + K/4 and a
    translation-soft prior (the long-lever-arm shape the sparse solver's
    step control exists for)."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.graph import factors as F

    rs = np.random.RandomState(0)
    truth = np.zeros((K, 6), np.float32)
    truth[:, 3] = np.arange(K)
    poses = truth + rs.randn(K, 6).astype(np.float32) * 0.02
    B = (K - 1) + 64
    bt_i, bt_j = np.zeros(B, np.int32), np.zeros(B, np.int32)
    bt_i[:K - 1], bt_j[:K - 1] = np.arange(K - 1), np.arange(1, K)
    meas = np.tile(np.array([0, 0, 0, 1, 0, 0], np.float32), (B, 1))
    bt_mask = np.zeros(B, bool)
    bt_mask[:K - 1] = True
    for q in range(n_loops):
        s = (K - 1) + q
        bt_i[s], bt_j[s] = q * (K // 16), q * (K // 16) + K // 4
        meas[s, 3] = K // 4
        bt_mask[s] = True
    info = F.info_from_variances((1e-6, 1e-6, 1e-6, 1e-4, 1e-4, 1e-4))
    to = lambda a: torch.from_numpy(a).to(dev)
    g = F.empty_graph(K, B, 64, device=dev)._replace(
        poses=to(poses), pose_mask=torch.ones(K, dtype=torch.bool, device=dev),
        prior_pose=to(poses[0]),
        prior_info=F.info_from_variances((1e-2, 1e-2, math.pi ** 2, 1e8, 1e8,
                                          1e8)).to(dev),
        bt_i=to(bt_i), bt_j=to(bt_j), bt_meas=to(meas),
        bt_info=info.to(dev)[None].repeat(B, 1), bt_mask=to(bt_mask))
    return g


def solver_check(graph, dev):
    """The sparse full-graph solve against the dense one on the mission's
    final graph (poses perturbed by seeded noise, so that there is a step to
    take): poses within 5e-3, the limit the sparse solver is held to against
    the dense one in the tests.  The last pose's marginal covariance is
    printed from both and held to be finite and positive only: this graph is
    anchored by a few GPS factors of 1 m^2, so its covariance is set by the
    solvers' relative damping, which the sparse factorization applies twice
    a block and the dense one once.  Then the time of one 5-iteration solve
    at K=256 (the mission's graph, both solvers) and at K=2048 (a chain with
    8 loops, sparse; dense would hold a 12288^2 system), which must lower
    the graph's chi2."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.graph import factors as F
    from lio_slam_tpu_torch.graph import solver, sparse

    K = graph.poses.shape[0]
    n_act = int(graph.pose_mask.sum())
    rs = np.random.RandomState(3)
    noise = torch.from_numpy((rs.randn(K, 6) * 0.01).astype(np.float32)).to(dev)
    g = graph._replace(poses=graph.poses
                       + noise * graph.pose_mask[:, None].float())
    dense, dense_ms = synced_ms(lambda: solver.solve(g, g.pose_mask, iterations=5))
    sp, sparse_ms = synced_ms(lambda: sparse.solve_sparse(g, iterations=5))
    diff = float((sp.graph.poses - dense.graph.poses).abs().max())
    moved = float((dense.graph.poses - g.poses).abs().max())
    idx = torch.tensor(n_act - 1, device=dev)
    cd = solver.marginal_covariance(g, idx)
    cs = sparse.marginal_covariance_sparse(g, idx)
    print(f"solver check on the mission's graph (K={K}, {n_act} active poses, "
          f"{int(g.bt_mask[K - 1:].sum())} loop and {int(g.gps_mask.sum())} GPS "
          f"factors): sparse against dense max pose difference {diff:.3e} "
          f"(the solve moved poses by up to {moved:.3e}); chi2 dense "
          f"{float(dense.chi2):.4f} sparse {float(sp.chi2):.4f}", flush=True)
    if not (diff <= 5e-3 and math.isfinite(diff)):
        fail(f"sparse solve differs from the dense one by {diff}")
    if moved < 1e-3:
        fail("the solver check's solve moved nothing")
    fmt = lambda c: " ".join(f"{x:.3e}" for x in c.diagonal().tolist())
    print(f"marginal covariance of pose {n_act - 1}, diagonal: dense {fmt(cd)}; "
          f"sparse {fmt(cs)}", flush=True)
    for c in (cd, cs):
        if not (bool(torch.isfinite(c).all()) and bool((c.diagonal() > 0).all())):
            fail(f"marginal covariance {c.diagonal().tolist()}")
    # the timed solves run once more (everything is loaded by now)
    _, dense_ms = synced_ms(lambda: solver.solve(g, g.pose_mask, iterations=5))
    _, sparse_ms = synced_ms(lambda: sparse.solve_sparse(g, iterations=5))
    full = lever_graph(K, 8, dev)
    _, sparse_full_ms = synced_ms(lambda: sparse.solve_sparse(full, iterations=5))
    big = lever_graph(2048, 8, dev)
    r, big_ms = synced_ms(lambda: sparse.solve_sparse(big, iterations=5))
    before, after = float(F.graph_chi2(big)), float(F.graph_chi2(r.graph))
    if not (math.isfinite(after) and after < before):
        fail(f"the K=2048 sparse solve took chi2 from {before} to {after}")
    print(f"solve times, one 5-iteration full-graph solve, ms (host clock, "
          f"device synchronized): K={K} mission graph ({n_act} active) dense "
          f"{dense_ms:.1f}, sparse {sparse_ms:.1f}; K={K} all active with 8 "
          f"loops sparse {sparse_full_ms:.1f}; K=2048 all active with 8 loops "
          f"sparse {big_ms:.1f} (chi2 {before:.4g} -> {after:.4g})", flush=True)


def verification_kernel_check(runner, cfg, pair, dev):
    """The kernel the way loop verification launches it: the table is a
    submap grid built in one shot by `build_grid` around a matched keyframe
    of this mission, the scan is a keyframe cloud.  Held to its plain
    version with the kernel phase's tolerances."""
    import torch

    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.ops import voxel_grid as vg
    from lio_slam_tpu_torch.pipeline import loop_closure

    r, l, s = cfg.registration, cfg.loop, cfg.static
    store = runner.state.store
    cur, cand = (torch.tensor(int(k), device=dev) for k in pair)
    submap = loop_closure._submap_around(store, cand, l.search_num,
                                         s.icp_submap_points,
                                         r.mapping_surf_leaf_size)
    grid = vg.build_grid(submap.xyz, submap.mask, r.nn_radius,
                         r.grid_table_size, r.grid_max_per_cell,
                         halo=r.grid_halo)
    scan, mask, pose = store.clouds[cur], store.cloud_masks[cur], store.poses[cur]
    kw = dict(halo=r.grid_halo, nn_radius=r.nn_radius,
              plane_dist_thresh=r.plane_dist_thresh,
              robust_weight_floor=r.robust_weight_floor)
    print(f"verification kernel check: keyframe {int(cur)} ({int(mask.sum())} of "
          f"{mask.numel()} points) against the submap around keyframe "
          f"{int(cand)} ({int(submap.mask.sum())} of {submap.mask.numel()} "
          f"points, {int(grid.counts.sum())} slots of a "
          f"{grid.table.shape[0]} x {grid.table.shape[1]} table filled)",
          flush=True)
    out = fc.fused_normal_equations(grid, scan, mask, pose, **kw)
    torch.cuda.synchronize()
    err = check_ne("submap-grid", out,
                   fc.fused_normal_equations_ref(grid, scan, mask, pose, **kw))
    if int(out[2]) < 100:
        fail(f"only {int(out[2])} inliers of a keyframe against its own submap")
    ms = device_ms(lambda: fc.fused_normal_equations(grid, scan, mask, pose, **kw))
    plain_ms = device_ms(lambda: fc.fused_normal_equations_ref(
        grid, scan, mask, pose, **kw))
    print(f"verification shapes, bucket ids + sums, device ms per call: kernel "
          f"route {ms:.4f}, plain version {plain_ms:.4f}", flush=True)
    return err


def loop_mission_phase(profile_dir=None):
    """The loop mission through `Runner(cfg)` on the card (its default
    device); returns (kernel launches of mapping, of loop verification, the
    submap-grid check's largest difference)."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.ops import voxel_grid as vg
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm
    from lio_slam_tpu_torch.pipeline.runner import Runner

    fixture = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                                   "loop_mission_jax.npz"))
    cfg = sm.loop_mission_config()
    seq, scans, imus, fixes = sm.loop_mission_inputs(cfg)
    runner = Runner(cfg, loop_every=sm.LOOP_EVERY)
    dev = runner.device
    if dev.type != "cuda":
        fail(f"Runner(cfg) chose {dev}, not the card")

    # every grid built whole (full corrections' rebuilds, verifications'
    # submap grids) goes through vg.build_grid: count them
    builds = [0]
    build_grid = vg.build_grid

    def counting_build(*a, **k):
        builds[0] += 1
        return build_grid(*a, **k)

    vg.build_grid = counting_build
    events = {"full_correction": [], "loop_closure": []}
    full_correct, detector = runner.full_correct, runner.detector

    flag_reads = [0]

    def timed_correct(state):
        flag_reads[0] += 1
        launches = fc.KERNEL_LAUNCHES
        new, ms = synced_ms(lambda: full_correct(state))
        if new is not state:
            events["full_correction"].append(ms)
        if fc.KERNEL_LAUNCHES != launches:
            fail("the full correction launched the registration kernel")
        return new

    cycles = []

    def timed_detector(state):
        launches = fc.KERNEL_LAUNCHES
        (new, aux), ms = synced_ms(lambda: detector(state))
        n_it = sum(aux["loop_iters"])
        if fc.KERNEL_LAUNCHES - launches != n_it:
            fail(f"a detector cycle launched the kernel "
                 f"{fc.KERNEL_LAUNCHES - launches} times for {n_it} GN "
                 "iterations of verification")
        cycles.append({"scan": runner.scan_count - 1, "ms": ms,
                       "verifications": len(aux["loop_iters"]), "iters": n_it,
                       **{k: aux[k].cpu().numpy() for k in
                          ("loop_accepted", "loop_pair_i", "loop_pair_j",
                           "loop_fitness")}})
        events["loop_closure"].append(ms)
        return new, aux

    runner.full_correct, runner.detector = timed_correct, timed_detector

    zero_launches()
    results, loops, gps = [], [], []
    t0 = time.perf_counter()
    for i in range(len(scans)):
        results.append(runner.process_scan(scans[i], imu=imus[i],
                                           gps_fixes=fixes[i]))
        loops.append(int(runner.state.loop_count))
        gps.append(int(runner.state.gps_count))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = fc.KERNEL_LAUNCHES
    gn_launches("loop", launches)
    vg.build_grid = build_grid
    runner.full_correct, runner.detector = full_correct, detector

    poses = np.stack([r.pose for r in results])
    if not np.isfinite(poses).all():
        fail("loop mission: non-finite poses")
    map_iters = sum(r.registration_iters for r in results)
    ver_iters = sum(c["iters"] for c in cycles)
    n_ver = sum(c["verifications"] for c in cycles)
    corrected = runner.full_correction_scans
    print(f"loop mission: {len(scans)} scans in {elapsed:.3f} s = "
          f"{len(scans) / elapsed:.3f} scans/s (the events' timing "
          f"synchronizes the device); kernel launches {launches} = "
          f"{map_iters} GN iterations of mapping + {ver_iters} of "
          f"{n_ver} loop verifications (JAX reference: {int(fixture['registration_iters'].sum())} "
          "of mapping)", flush=True)
    if map_iters == 0 or ver_iters == 0 or launches != map_iters + ver_iters:
        fail(f"kernel launches {launches} != {map_iters} (mapping) + "
             f"{ver_iters} (verification)")
    for c in cycles:
        if c["verifications"]:
            print(f"  detector cycle at scan {c['scan']}: "
                  f"{c['verifications']} verification(s), {c['iters']} GN "
                  f"iterations, accepted {c['loop_accepted'].tolist()}, pair "
                  f"{c['loop_pair_i'].tolist()} -> {c['loop_pair_j'].tolist()}, "
                  f"fitness {[round(float(x), 5) for x in c['loop_fitness']]}, "
                  f"{c['ms']:.1f} ms", flush=True)
    ref_cycles = [(int(s), a.tolist(), j.tolist()) for s, a, j in
                  zip(fixture["cycle_scan"], fixture["loop_accepted"],
                      fixture["loop_pair_j"]) if a.any()]
    print(f"loop mission: loop factors {loops[-1]} (JAX {int(fixture['loop_count'][-1])}), "
          f"GPS factors {gps[-1]} (JAX {int(fixture['gps_count'][-1])}), "
          f"keyframes {int(runner.state.store.count)} (JAX {int(fixture['keyframes'])}); "
          f"full corrections at scans {corrected} (JAX "
          f"{fixture['full_correction_scans'].tolist()}); grids built whole: "
          f"{builds[0]} = {len(corrected)} rebuilds + {n_ver} submap grids; "
          f"JAX accepted cycles (scan, [radius, SC], matched): {ref_cycles}",
          flush=True)
    if loops[-1] < 1 or loops[-1] != int(fixture["loop_count"][-1]):
        fail(f"{loops[-1]} loop factors, JAX reference {int(fixture['loop_count'][-1])}")
    if gps[-1] < 1 or gps[-1] != int(fixture["gps_count"][-1]):
        fail(f"{gps[-1]} GPS factors, JAX reference {int(fixture['gps_count'][-1])}")
    if not corrected or builds[0] != len(corrected) + n_ver:
        fail(f"{len(corrected)} full corrections, {builds[0]} grids built whole")
    if bool(runner.state.needs_full_solve):
        fail("a factor was left without its full correction")

    ate = synthetic.ate_rmse(poses, sm.relative_truth(seq))
    d = np.abs(poses - fixture["poses"])
    first = min(int(fixture["full_correction_scans"][0]), corrected[0])
    first_loop = min([c["scan"] for c in cycles if c["loop_accepted"].any()]
                     + [int(s) for s, a in zip(fixture["cycle_scan"],
                                               fixture["loop_accepted"])
                        if a.any()])
    spans = (("before the first full correction", slice(0, first + 1),
              MAX_DEV_M, MAX_DEV_RAD),
             ("up to the first accepted loop", slice(0, first_loop + 1),
              LOOP_GPS_MAX_DEV_M, LOOP_GPS_MAX_DEV_RAD),
             ("whole mission", slice(None), LOOP_MAX_DEV_M, LOOP_MAX_DEV_RAD))
    failures = []
    err_truth = np.linalg.norm(poses[:, 3:] - sm.relative_truth(seq)[:, 3:], axis=1)
    print("loop mission: distance from truth, m, every 5th scan: "
          + " ".join(f"{x:.3f}" for x in err_truth[::5]) + "; from the JAX "
          "reference: " + " ".join(f"{x:.3f}" for x in
                                   np.linalg.norm(d[:, 3:], axis=1)[::5]),
          flush=True)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        np.savez(os.path.join(profile_dir, "loop_mission_run.npz"), poses=poses,
                 is_keyframe=np.array([r.is_keyframe for r in results]),
                 registration_iters=np.array([r.registration_iters
                                              for r in results]),
                 loop_count=np.array(loops), gps_count=np.array(gps),
                 full_correction_scans=np.array(corrected),
                 keyframe_poses=runner.state.store.poses.cpu().numpy())
    failures += deviation_spans("loop mission", poses, fixture["poses"], spans)
    n_kf = int(runner.state.store.count)
    if n_kf == int(fixture["keyframes"]):
        dk = np.abs(runner.state.store.poses[:n_kf].cpu().numpy()
                    - fixture["keyframe_poses"])
        print(f"loop mission: final keyframe poses within {dk[:, 3:].max():.3e} m, "
              f"{math.degrees(dk[:, :3].max()):.3e} deg of the JAX reference's",
              flush=True)
    print(f"loop mission: ATE {ate:.5f} m (JAX reference run "
          f"{float(fixture['ate_rmse_m']):.5f} m, limit {LOOP_MAX_ATE_M} m); "
          f"mapping_error {runner.mapping_error}", flush=True)
    if not (ate <= LOOP_MAX_ATE_M):
        failures.append(f"loop mission: ATE {ate} m against truth")
    if failures:
        fail("; ".join(failures))
    if runner.mapping_error:
        fail("loop mission: IMU front-end reported a mapping error")

    med = lambda xs: sorted(xs)[len(xs) // 2] if xs else float("nan")
    ran = [c["ms"] for c in cycles if c["verifications"]]
    idle = [c["ms"] for c in cycles if not c["verifications"]]
    host = {k: round(v["mean_ms"], 3) for k, v in runner.timer.as_dict().items()}
    print(f"loop mission events, ms on the host's clock with the device "
          f"synchronized: full correction (K={cfg.static.max_keyframes} dense "
          f"solve x5 + map rebuild) median {med(events['full_correction']):.1f}, "
          f"max {max(events['full_correction']):.1f} over "
          f"{len(events['full_correction'])}; detector cycle with verification "
          f"median {med(ran):.1f}, max {max(ran, default=float('nan')):.1f} over {len(ran)}; without "
          f"a candidate median {med(idle):.2f} over {len(idle)}; stages, host "
          f"ms per entry: {json.dumps(host)}", flush=True)

    # one more of each event on the final state under the profiler: the
    # device's own time and the number of kernels it took
    st = runner.state
    _, read_ms = synced_ms(lambda: [bool(st.needs_full_solve)
                                    for _ in range(100)])
    print(f"host read of needs_full_solve (one a scan once a GPS candidate or "
          f"a detector cycle has armed it; on {flag_reads[0]} of {len(scans)} "
          f"scans here): {10 * read_ms:.1f} us a read on an idle device",
          flush=True)
    _, busy, n_dev, wall = profiled_once(lambda: runner.full_correct(
        st._replace(needs_full_solve=torch.ones_like(st.needs_full_solve))))
    print(f"profiled full correction on the final state: device busy "
          f"{busy:.2f} ms in {n_dev} kernels and copies, {wall:.1f} ms wall "
          "under the profiler", flush=True)
    launches_before = fc.KERNEL_LAUNCHES
    (_, aux), busy, n_dev, wall = profiled_once(lambda: runner.detector(
        st._replace(last_loop_kf=torch.full_like(st.last_loop_kf, -1))))
    print(f"profiled detector cycle on the final state: "
          f"{len(aux['loop_iters'])} verification(s), "
          f"{fc.KERNEL_LAUNCHES - launches_before} launches of the fused "
          f"kernel, device busy {busy:.2f} ms in {n_dev} kernels and copies, "
          f"{wall:.1f} ms wall under the profiler", flush=True)

    accepted = [c for c in cycles if c["loop_accepted"].any()]
    k = int(np.argmax(accepted[0]["loop_accepted"]))
    pair = (accepted[0]["loop_pair_i"][k], accepted[0]["loop_pair_j"][k])
    err = verification_kernel_check(runner, cfg, pair, dev)
    solver_check(runner.state.graph, dev)
    return map_iters, ver_iters, err


def run_wrapped(obj, name, wrapper):
    """Replace `obj.name` by `wrapper(original)`; returns a function that
    puts the original back."""
    original = getattr(obj, name)
    setattr(obj, name, wrapper(original))
    return lambda: setattr(obj, name, original)


def deviation_spans(label, poses, ref, spans):
    """Print the largest deviation from the reference in each span; returns
    the spans over their limits."""
    import numpy as np

    d = np.abs(poses - ref)
    failures = []
    for name, sl, lim_m, lim_rad in spans:
        dm, dr = float(d[sl, 3:].max()), float(d[sl, :3].max())
        print(f"{label}, {name} (scans {sl.start or 0}-{(sl.stop or len(poses)) - 1})"
              f": max deviation from the JAX reference {dm:.3e} m, "
              f"{math.degrees(dr):.3e} deg (limits {lim_m} m, "
              f"{math.degrees(lim_rad):.2f} deg)", flush=True)
        if not (dm <= lim_m and dr <= lim_rad):
            failures.append(f"{label}, {name}: {dm} m / {dr} rad")
    return failures


def archive_kernel_check(runner, cfg, gid_i, gid_j, dev):
    """The kernel the way archive verification launches it: the table is a
    grid built whole over the ARCHIVED submap around keyframe `gid_j` (the
    evicted match), the scan is the archived cloud of keyframe `gid_i` (the
    query).  Held to its plain version with the kernel phase's tolerances."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.ops import voxel_grid as vg
    from lio_slam_tpu_torch.utils import pointcloud as pc

    r, l, s = cfg.registration, cfg.loop, cfg.static
    a = runner._archive
    pts = a.submap(gid_j, l.search_num, max_points=s.max_map_points)
    submap = pc.voxel_downsample(pc.pad_cloud(pts, s.max_map_points, device=dev),
                                 r.mapping_surf_leaf_size, s.icp_submap_points)
    grid = vg.build_grid(submap.xyz, submap.mask, r.nn_radius,
                         r.grid_table_size, r.grid_max_per_cell,
                         halo=r.grid_halo)
    k = gid_i - a.base_gid
    cloud = pc.pad_cloud(a.clouds[k], s.max_keyframe_points, device=dev)
    pose = torch.from_numpy(np.asarray(a.poses[k], np.float32)).to(dev)
    kw = dict(halo=r.grid_halo, nn_radius=r.nn_radius,
              plane_dist_thresh=r.plane_dist_thresh,
              robust_weight_floor=r.robust_weight_floor)
    print(f"archive verification kernel check: archived keyframe {gid_i} "
          f"({int(cloud.mask.sum())} points) against the archived submap around "
          f"evicted keyframe {gid_j} ({pts.shape[0]} points, "
          f"{int(submap.mask.sum())} after the downsample, "
          f"{int(grid.counts.sum())} slots filled)", flush=True)
    out = fc.fused_normal_equations(grid, cloud.xyz, cloud.mask, pose, **kw)
    torch.cuda.synchronize()
    err = check_ne("archive-submap-grid", out, fc.fused_normal_equations_ref(
        grid, cloud.xyz, cloud.mask, pose, **kw))
    if int(out[2]) < 100:
        fail(f"only {int(out[2])} inliers of a keyframe against its archived place")
    ms = device_ms(lambda: fc.fused_normal_equations(grid, cloud.xyz, cloud.mask,
                                                     pose, **kw))
    plain_ms = device_ms(lambda: fc.fused_normal_equations_ref(
        grid, cloud.xyz, cloud.mask, pose, **kw))
    print(f"archive verification shapes, bucket ids + sums, device ms per call: "
          f"kernel route {ms:.4f}, plain version {plain_ms:.4f}", flush=True)
    return err


def within(label, got, ref, rel=0.005):
    """(message, ok): `got` within `rel` of the reference's `ref`."""
    ok = abs(got - ref) <= rel * max(abs(ref), 1)
    return f"{label} {got} (JAX {ref}, {100 * (got - ref) / max(ref, 1):+.2f} %)", ok


def products_phase(runner, cfg, seq, fixture, reg_iters, tmp):
    """The map products and three relocalizations on the archive mission's
    final state, against the reference's counts and results; returns the
    relocalizations' kernel launches."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.ops import heightmap
    from lio_slam_tpu_torch.pipeline import relocalization
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm
    from lio_slam_tpu_torch.utils import pointcloud as pc

    dev = runner.device
    pm, local_ms = synced_ms(runner.local_planning_map)
    hm, height_ms = synced_ms(runner.height_map)
    (_, slope), normals_ms = synced_ms(lambda: heightmap.normals_and_slope(hm))
    z = float(runner.trajectory[-1][5])
    sdf, sdf_ms = synced_ms(lambda: heightmap.obstacle_sdf(hm, z))
    saved, save_ms = synced_ms(lambda: runner.save_map(os.path.join(tmp, "maps"),
                                                       resolution=0.4))
    counts = {"SOR-kept points": (int(pm.count()), int(fixture["sor_kept"])),
              "occupied height cells": (int(torch.isfinite(hm.elevation).sum()),
                                        int(fixture["height_cells"])),
              "saved map points": (saved.num_points, int(fixture["saved_points"]))}
    print(f"products on the final state, ms (host clock, device synchronized): "
          f"local_planning_map {local_ms:.1f}, height_map {height_ms:.1f} (the "
          f"planning map again + the raster), normals_and_slope {normals_ms:.1f}, "
          f"obstacle_sdf {sdf_ms:.1f}, save_map {save_ms:.1f} ({len(saved.files)} "
          f"files); slope cells {int(torch.isfinite(slope).sum())} (JAX "
          f"{int(fixture['slope_cells'])}), SDF cells inside obstacles "
          f"{int((sdf < 0).sum())} (JAX {int(fixture['sdf_negative'])})",
          flush=True)
    failures = []
    for label, (got, ref) in counts.items():
        msg, ok = within(label, got, ref)
        print(f"products: {msg}", flush=True)
        if not ok:
            failures.append(msg)

    reloc = relocalization.make_relocalizer(cfg)
    launches = 0
    for k, i in enumerate(sm.RELOC_SCANS):
        cloud = pc.Cloud(xyz=torch.from_numpy(seq.scans[i]).to(dev),
                         mask=torch.from_numpy(seq.scan_masks[i]).to(dev))
        n_reg = len(reg_iters)
        zero_launches()
        r, ms = synced_ms(lambda: reloc(runner.state, cloud))
        n_launch = fc.KERNEL_LAUNCHES
        gn_launches("relocalization", n_launch)
        iters = sum(it for _, it in reg_iters[n_reg:])
        launches += n_launch
        pose = r.pose.cpu().numpy()
        ref = fixture["reloc_pose"][k]
        dm = float(np.abs(pose[3:] - ref[3:]).max())
        dr = float(np.abs((pose[:3] - ref[:3] + np.pi) % (2 * np.pi) - np.pi).max())
        print(f"relocalize first-lap scan {i}: success {bool(r.success)} (JAX "
              f"{bool(fixture['reloc_success'][k])}), keyframe {int(r.matched_kf)} "
              f"(JAX {int(fixture['reloc_matched_kf'][k])}), SC distance "
              f"{float(r.sc_distance):.4f}, fitness {float(r.fitness):.4f}, pose "
              f"{dm:.3e} m / {math.degrees(dr):.3e} deg from the JAX pose, "
              f"{n_launch} kernel launches for {iters} GN iterations, {ms:.1f} ms",
              flush=True)
        if n_launch != iters or n_launch == 0:
            failures.append(f"relocalization of scan {i}: {n_launch} launches, "
                            f"{iters} GN iterations")
        if not (bool(r.success) and int(r.matched_kf)
                == int(fixture["reloc_matched_kf"][k])):
            failures.append(f"relocalization of scan {i}: success "
                            f"{bool(r.success)}, keyframe {int(r.matched_kf)}")
        if not (dm <= MAX_DEV_M and dr <= MAX_DEV_RAD):
            failures.append(f"relocalization of scan {i}: {dm} m / {dr} rad "
                            "from the reference")
    if failures:
        fail("; ".join(failures))
    return launches


def archive_mission_phase(profile_dir=None):
    """The archive mission through `Runner(cfg, fetch_every=2, mission_log,
    auto_checkpoint)` on the card, against its JAX reference run; then the
    archive verification's kernel check and the products phase.  Returns
    the kernel launches by path and the kernel check's largest
    difference."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.ops import registration
    from lio_slam_tpu_torch.pipeline import checkpoint
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm
    from lio_slam_tpu_torch.pipeline.runner import Runner

    fixture = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                                   "archive_mission_jax.npz"))
    cfg = sm.archive_mission_config()
    seq, scans, imus, fixes = sm.loop_mission_inputs(cfg, n_scans=sm.ARCHIVE_SCANS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_archive_")
    try:
        log_path, ck = os.path.join(tmp, "mission.jsonl"), os.path.join(tmp, "auto.npz")
        runner = Runner(cfg, loop_every=sm.LOOP_EVERY, fetch_every=2,
                        mission_log=log_path, auto_checkpoint=ck,
                        checkpoint_every=50)
        dev = runner.device
        if dev.type != "cuda":
            fail(f"Runner(cfg) chose {dev}, not the card")
        # every registration's GN iterations, tagged with the path it ran on
        reg_iters, path = [], ["mapping"]

        def counting_register(register):
            def wrapped(*a, **k):
                r = register(*a, **k)
                reg_iters.append((path[0], r.iterations))
                return r
            return wrapped

        map_iters = []

        def counting_step(step):
            def wrapped(state, inp):
                state, out = step(state, inp)
                map_iters.append(out.registration_iters)
                return state, out
            return wrapped

        def tagged(tag, times):
            def wrap(fn):
                def wrapped(*a, **k):
                    path[0] = tag
                    launches = fc.KERNEL_LAUNCHES
                    n_reg, loops = len(reg_iters), runner.archive_loops
                    try:
                        out, ms = synced_ms(lambda: fn(*a, **k))
                    finally:
                        path[0] = "mapping"
                    times.append({"ms": ms, "scan": runner.scan_count - 1,
                                  "launches": fc.KERNEL_LAUNCHES - launches,
                                  "verifications": len(reg_iters) - n_reg,
                                  "iters": sum(i for _, i in reg_iters[n_reg:]),
                                  "accepted": runner.archive_loops - loops})
                    return out
                return wrapped
            return wrap

        attempts, cycles, saves = [], [], []
        restore = [run_wrapped(registration, "register", counting_register),
                   run_wrapped(runner, "step", counting_step),
                   run_wrapped(runner, "detector", tagged("detector", cycles)),
                   run_wrapped(runner, "_attempt_archive_loop",
                               tagged("archive", attempts)),
                   run_wrapped(runner, "save_checkpoint", tagged("save", saves))]

        zero_launches()
        t0 = time.perf_counter()
        for i in range(len(scans)):
            runner.process_scan(scans[i], imu=imus[i], gps_fixes=fixes[i])
        runner.drain()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = fc.KERNEL_LAUNCHES
        gn_launches("archive", launches)
        h = runner.health()
        runner.close()           # the last auto-checkpoint; the log is whole
        for undo in restore[1:]:
            undo()

        st = runner.state
        A = cfg.static.max_archive_anchors
        gmask = st.graph.gps_mask.cpu().numpy()
        ver_iters = sum(c["iters"] for c in cycles)
        arch_iters = sum(a["iters"] for a in attempts)
        arch_launches = sum(a["launches"] for a in attempts)
        n_ver = sum(a["verifications"] for a in attempts)
        recs = [json.loads(line) for line in open(log_path)]
        steps = [r for r in recs if "event" not in r]
        events = [(r["i"], r["j"]) for r in recs if r.get("source") == "archive"]
        got = {"evictions": h["keyframe_evictions"],
               "archived keyframes": h["archived_keyframes"],
               "archive loops": h["archive_loops"],
               "loop factors": int(st.loop_count), "GPS factors": int(st.gps_count),
               "anchors": int(gmask[len(gmask) - A:].sum()),
               "keyframes": int(st.store.count)}
        ref = {"evictions": int(fixture["evictions"]),
               "archived keyframes": int(fixture["archived_keyframes"]),
               "archive loops": int(fixture["archive_loops"]),
               "loop factors": int(fixture["loop_count"]),
               "GPS factors": int(fixture["gps_count"]),
               "anchors": int(fixture["anchors"]),
               "keyframes": int(fixture["keyframes"])}
        print(f"archive mission: {len(scans)} scans in {elapsed:.3f} s = "
              f"{len(scans) / elapsed:.3f} scans/s (fetch_every 2, mission log, "
              f"auto-checkpoint every 50; the events' timing synchronizes the "
              f"device); kernel launches {launches} = {sum(map_iters)} GN "
              f"iterations of mapping + {ver_iters} of loop verification + "
              f"{arch_iters} of {n_ver} archive verification(s) (JAX reference: "
              f"{int(fixture['registration_iters'].sum())} of mapping)", flush=True)
        print("archive mission counts (port / JAX): " + ", ".join(
            f"{k} {got[k]} / {ref[k]}" for k in got) + f"; full corrections at "
            f"scans {runner.full_correction_scans} (JAX "
            f"{fixture['full_correction_scans'].tolist()}); archive loop events "
            f"(i, j) {events} (JAX {fixture['archive_events'].tolist()}); "
            f"{len(steps)} step records", flush=True)
        failures = [f"{k} {got[k]}, JAX reference {ref[k]}" for k in got
                    if got[k] != ref[k]]
        if got["archive loops"] < 1 or got["evictions"] < 1:
            failures.append("the mission evicted nothing or closed no archive loop")
        if runner.full_correction_scans != fixture["full_correction_scans"].tolist():
            failures.append(f"full corrections at {runner.full_correction_scans}")
        if len(events) != got["archive loops"] or not all(i > j for i, j in events):
            failures.append(f"archive events {events} for {got['archive loops']} loops")
        if len(steps) != len(scans) or len(runner.trajectory) != len(scans):
            failures.append(f"{len(steps)} step records, {len(runner.trajectory)} poses")
        if launches != sum(map_iters) + ver_iters + arch_iters or arch_iters == 0 \
                or arch_launches != arch_iters:
            failures.append(f"kernel launches {launches} != {sum(map_iters)} + "
                            f"{ver_iters} + {arch_iters} (archive attempts launched "
                            f"{arch_launches})")

        poses = np.stack(runner.trajectory)
        first = min(int(fixture["full_correction_scans"][0]),
                    runner.full_correction_scans[0])
        first_hit = min([a["scan"] for a in attempts if a["verifications"]],
                        default=len(scans) - 1)
        failures += deviation_spans("archive mission", poses, fixture["poses"], (
            ("before the first full correction", slice(0, first + 1),
             MAX_DEV_M, MAX_DEV_RAD),
            ("up to the archive verification", slice(0, first_hit + 1),
             LOOP_GPS_MAX_DEV_M, LOOP_GPS_MAX_DEV_RAD),
            ("whole mission", slice(None), LOOP_MAX_DEV_M, LOOP_MAX_DEV_RAD)))
        ate = synthetic.ate_rmse(poses, sm.relative_truth(seq))
        print(f"archive mission: ATE {ate:.5f} m (JAX reference "
              f"{float(fixture['ate_rmse_m']):.5f} m, limit {LOOP_MAX_ATE_M} m); "
              f"mapping_error {runner.mapping_error}; live GPS factors "
              f"{int(gmask[:len(gmask) - A].sum())} (JAX {int(fixture['live_gps'])})",
              flush=True)
        if not ate <= LOOP_MAX_ATE_M or runner.mapping_error:
            failures.append(f"archive mission: ATE {ate} m, mapping_error "
                            f"{runner.mapping_error}")
        if failures:
            fail("; ".join(failures))

        med = lambda xs: sorted(xs)[len(xs) // 2] if xs else float("nan")
        hit = [a["ms"] for a in attempts if a["verifications"]]
        miss = [a["ms"] for a in attempts if not a["verifications"]]
        _, load_ms = synced_ms(lambda: checkpoint.load_checkpoint(ck, cfg, device=dev))
        host = {k: round(v["mean_ms"], 3) for k, v in runner.timer.as_dict().items()}
        print(f"archive mission events, ms on the host's clock with the device "
              f"synchronized: archive attempt with a verification "
              f"{', '.join(f'{x:.1f}' for x in hit)} (scans "
              f"{[a['scan'] for a in attempts if a['verifications']]}); without "
              f"one median {med(miss):.2f}, max {max(miss, default=float('nan')):.2f} "
              f"over {len(miss)}; checkpoint save {', '.join(f'{s_['ms']:.1f}' for s_ in saves)} "
              f"(scans {[s_['scan'] for s_ in saves]}), load {load_ms:.1f} "
              f"({os.path.getsize(ck)} B + sidecar "
              f"{os.path.getsize(ck + '.archive.npz')} B); detector cycle median "
              f"{med([c['ms'] for c in cycles]):.2f}; stages, host ms per entry: "
              f"{json.dumps(host)}", flush=True)
        gid_i, gid_j = events[0]
        err = archive_kernel_check(runner, cfg, gid_i, gid_j, dev)
        reloc_launches = products_phase(runner, cfg, seq, fixture, reg_iters, tmp)
        restore[0]()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ({"archive_mapping": sum(map_iters), "archive_detector": ver_iters,
             "archive_verification": arch_iters,
             "relocalization": reloc_launches}, err)


def resume_phase(dev):
    """The 40-scan mission (loop closure and GPS off) with a checkpoint at
    scan RESUME_AT, then `Runner.resume` of it on the card over the
    remaining scans: their poses must equal the uninterrupted run's to
    1e-6 (the same bits are expected).  Returns the resumed run's kernel
    launches."""
    import shutil
    import tempfile

    import numpy as np

    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm
    from lio_slam_tpu_torch.pipeline.runner import Runner

    cfg = sm.bench_config()
    seq = synthetic.make_sequence(n_scans=sm.SMOKE_SCANS, n_points=sm.SMOKE_POINTS,
                                  seed=sm.SMOKE_SEED, speed=sm.SMOKE_SPEED)
    scans, imus = sm.synthetic_inputs(seq, cfg)
    at = sm.RESUME_AT
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        path = os.path.join(tmp, "resume.npz")
        whole = Runner(cfg, device=dev)
        ref = []
        for i in range(len(scans)):
            if i == at:
                _, save_ms = synced_ms(lambda: whole.save_checkpoint(path))
            ref.append(whole.process_scan(scans[i], imu=imus[i]))
        zero_launches()
        resumed, load_ms = synced_ms(lambda: Runner.resume(path, cfg, device=dev))
        out = [resumed.process_scan(scans[i], imu=imus[i])
               for i in range(at, len(scans))]
        launches = fc.KERNEL_LAUNCHES
        gn_launches("resume", launches,
                    sum(r.registration_iters > 0 for r in out))
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a = np.stack([r.pose for r in ref[at:]])
    b = np.stack([r.pose for r in out])
    iters = sum(r.registration_iters for r in out)
    d = np.abs(a - b)
    print(f"resume: checkpoint at scan {at} of the {len(scans)}-scan mission "
          f"(K={cfg.static.max_keyframes}, {size} B), save {save_ms:.1f} ms, "
          f"Runner.resume {load_ms:.1f} ms (host clock, device synchronized); "
          f"scans {at}-{len(scans) - 1} resumed: max deviation from the "
          f"uninterrupted run {d[:, 3:].max():.3e} m, {d[:, :3].max():.3e} rad, "
          f"bit-equal {bool((a == b).all())}; keyframe flags equal "
          f"{[r.is_keyframe for r in out] == [r.is_keyframe for r in ref[at:]]}; "
          f"{launches} kernel launches for {iters} GN iterations", flush=True)
    if not d.max() <= 1e-6:
        fail(f"the resumed run is {d.max()} from the uninterrupted one")
    if launches != iters or launches == 0:
        fail(f"resume: {launches} kernel launches for {iters} GN iterations")
    return launches


def timed(store):
    """A `run_wrapped` wrapper that appends each call's host seconds to
    `store`."""
    def wrap(fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                store.append(time.perf_counter() - t0)
        return wrapped
    return wrap


def write_bag(path, kwargs, fixture, key):
    """The bag through the port's `write_synthetic_bag`; fails unless its
    sha256 is the one the fixture's reference run replayed.  Returns (truth,
    seconds)."""
    import hashlib

    from lio_slam_tpu_torch.io.synthetic_bag import write_synthetic_bag

    t0 = time.perf_counter()
    truth = write_synthetic_bag(path, **kwargs)
    seconds = time.perf_counter() - t0
    digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
    ref = str(fixture[key + "bag_sha256"])
    print(f"{key or 'mission '}bag: {os.path.getsize(path)} B written in "
          f"{seconds:.2f} s (host), sha256 {digest} (the reference replayed "
          f"{ref})", flush=True)
    if digest != ref:
        fail(f"the {key or 'mission '}bag differs from the one the reference "
             "replayed")
    return truth, seconds


def replay_on_card(runner, path, topics, capture_at, label):
    """`replay_bag(runner, path, BagTopics(**topics), use_native=True)` with
    host timers around the cloud decode, the feed's IMU windowing and
    `process_scan`, and the arguments of kernel launch number `capture_at`
    cloned for the kernel check; gn_small's launches go to `GN_PATHS[label]`.
    Returns (results, loop and GPS factor counts after each scan, seconds,
    the LiveFeed, timers, captured arguments, launches)."""
    import torch

    from lio_slam_tpu_torch.io import bag_replay
    from lio_slam_tpu_torch.io import rosbag as rb
    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.pipeline import live

    timers = {k: [] for k in ("decode", "adapt", "window", "process_scan")}
    feeds, captured = [], []

    def capturing_feed(cls):
        def make(*a, **k):
            feeds.append(cls(*a, **k))
            return feeds[-1]
        return make

    restore = [run_wrapped(bag_replay, "LiveFeed", capturing_feed),
               run_wrapped(rb, "decode_pointcloud2", timed(timers["decode"])),
               run_wrapped(rb, "scan_from_pointcloud2", timed(timers["adapt"])),
               run_wrapped(live.LiveFeed, "_window_for", timed(timers["window"])),
               run_wrapped(runner, "process_scan", timed(timers["process_scan"])),
               run_wrapped(fc, "fused_ne_from_bucket_ids",
                           capturing(capture_at, captured))]
    results, loops, gps = [], [], []
    try:
        zero_launches()
        t0 = time.perf_counter()
        for r in bag_replay.replay_bag(runner, path,
                                       bag_replay.BagTopics(**topics),
                                       use_native=True):
            results.append(r)
            loops.append(int(runner.state.loop_count))
            gps.append(int(runner.state.gps_count))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = fc.KERNEL_LAUNCHES
        # a config without loop closure registers only its scans
        gn_launches(label, launches,
                    sum(r.registration_iters > 0 for r in results)
                    if not runner.cfg.loop.enabled else None)
    finally:
        for undo in restore:
            undo()
    if len(feeds) != 1 or not feeds[0].native_active:
        fail("the replay did not run on the native sample queue")
    if not captured:
        fail(f"kernel launch {capture_at} never came")
    return results, loops, gps, seconds, feeds[0], timers, captured[0], launches


def print_intake_times(label, n, seconds, timers, write_s, read_s):
    ms = lambda k: 1e3 * sum(timers[k]) / max(len(timers[k]), 1)
    print(f"{label} times, host clock ({SMI}): {n} scans in {seconds:.3f} s = "
          f"{n / seconds:.3f} scans/s over the replay (bag read, decode, feed "
          f"and process_scan); ms a scan: decode_pointcloud2 {ms('decode'):.3f}, "
          f"scan_from_pointcloud2 {ms('adapt'):.3f}, the feed's IMU windowing "
          f"{ms('window'):.3f}, process_scan {ms('process_scan'):.3f}; reading "
          f"every record of the bag {1e3 * read_s:.1f} ms; bag write "
          f"{write_s:.2f} s", flush=True)


def bag_kernel_check(name, captured):
    """The kernel on the arguments it was launched with on a bag path, held
    to its plain version: inliers exact, the sums within rtol 1e-4, and
    each AtA / Atb entry within rtol 2e-4 / atol 2e-3 of the plain version
    or, where the entry is a sum that cancels (the bag scenes are close to
    planar, and a cross term of 1e1 sums terms of 1e4), no farther from the
    plain version evaluated in float64 than 2e-3 + 2e-4 |entry| plus four
    times the largest rounding of the plain float32 version itself on the
    same inputs; that float64 evaluation must then select the same inliers.
    Returns the largest |AtA, Atb| difference from the plain float32
    version."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.ops import fused_corr as fc

    args, kw = captured
    out = fc.fused_ne_from_bucket_ids(*args, **kw)
    ref = fc.fused_ne_from_bucket_ids_ref(*args, **kw)
    ref64 = fc.fused_ne_from_bucket_ids_ref(
        *[x.double() if torch.is_tensor(x) and x.dtype == torch.float32 else x
          for x in args], **kw)
    g, r, r64 = ([x.detach().double().cpu().numpy() for x in o]
                 for o in (out, ref, ref64))
    if int(g[2]) != int(r[2]) or int(g[2]) < 100:
        fail(f"{name}: inliers {int(g[2])}, plain {int(r[2])}")
    for i, label in ((3, "sum s"), (4, "sum s|pd2|")):
        if not np.isclose(g[i], r[i], rtol=1e-4, atol=1e-4):
            fail(f"{name}: {label} {g[i]} != plain {r[i]}")
    errs = []
    for i, label in ((0, "AtA"), (1, "Atb")):
        band = 2e-3 + 2e-4 * np.abs(r[i])
        outside = int((np.abs(g[i] - r[i]) > band).sum())
        rounding = float(np.abs(r[i] - r64[i]).max())
        far = np.abs(g[i] - r64[i]) - (2e-3 + 2e-4 * np.abs(r64[i]) + 4 * rounding)
        print(f"kernel check {name} {label}: max |kernel - plain| "
              f"{np.abs(g[i] - r[i]).max():.3e} ({outside} entries outside rtol "
              f"2e-4 / atol 2e-3); against the plain version in float64: kernel "
              f"{np.abs(g[i] - r64[i]).max():.3e}, plain float32 {rounding:.3e}",
              flush=True)
        if outside and (int(r64[2]) != int(r[2]) or (far > 0).any()):
            fail(f"{name}: {label} entries beyond the float32 rounding of the "
                 f"plain version by up to {far.max()} (float64 inliers "
                 f"{int(r64[2])})")
        errs.append(float(np.abs(g[i] - r[i]).max()))
    print(f"kernel check {name}: inliers {int(g[2])} = plain (float64: "
          f"{int(r64[2])})", flush=True)
    return max(errs)


def bag_read_seconds(path):
    from lio_slam_tpu_torch.io import rosbag as rb

    t0 = time.perf_counter()
    for _ in rb.BagReader(path).read_messages():
        pass
    return time.perf_counter() - t0


def bag_mission_phase():
    """Phase 12: the bag mission.  The port writes the 125-scan bag (its
    sha256 must be the one the reference replayed), replays it through
    `replay_bag` on the native queues into `Runner(loop_mission_config(),
    loop_every=10, record_bag=...)` on the card, and holds counts,
    trajectory, launches and the recorded bag to the JAX reference run.
    Returns (launches of mapping, of loop verification, the kernel check's
    largest difference)."""
    import collections
    import shutil
    import tempfile

    import numpy as np
    import torch

    from lio_slam_tpu_torch.io import rosbag as rb
    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm
    from lio_slam_tpu_torch.pipeline.runner import Runner
    from lio_slam_tpu_torch.utils import se3

    fixture = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                                   "bag_mission_jax.npz"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bag_")
    try:
        path, rec = os.path.join(tmp, "mission.bag"), os.path.join(tmp, "out.bag")
        truth, write_s = write_bag(path, sm.bag_mission_bag_kwargs(), fixture, "")
        cfg = sm.loop_mission_config()
        runner = Runner(cfg, loop_every=sm.LOOP_EVERY, record_bag=rec)
        if runner.device.type != "cuda":
            fail(f"Runner(cfg) chose {runner.device}, not the card")
        cycles = []

        def counting_detector(detector):
            def wrapped(state):
                launches = fc.KERNEL_LAUNCHES
                state, aux = detector(state)
                cycles.append({"scan": runner.scan_count - 1,
                               "iters": sum(aux["loop_iters"]),
                               "launches": fc.KERNEL_LAUNCHES - launches,
                               "accepted": aux["loop_accepted"].cpu().numpy()})
                return state, aux
            return wrapped

        undo = run_wrapped(runner, "detector", counting_detector)
        results, loops, gps, seconds, feed, timers, captured, launches = \
            replay_on_card(runner, path, sm.BAG_TOPICS, BAG_CAPTURE_AT, "bag")
        undo()
        runner.close()                          # writes the output bag
        read_s = bag_read_seconds(path)
        recorded = collections.Counter()
        odometry = []
        for m in rb.BagReader(rec).read_messages():
            recorded[m.topic] += 1
            if m.topic == "/liorf/mapping/odometry":
                odometry.append(m.decode().position)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    n = len(results)
    poses = np.stack([r.pose for r in results])
    map_iters = sum(r.registration_iters for r in results)
    ver_iters = sum(c["iters"] for c in cycles)
    corrected = runner.full_correction_scans
    got = {"scans": n, "keyframes": int(runner.state.store.count),
           "loop factors": loops[-1], "GPS factors": gps[-1]}
    ref = {"scans": len(fixture["poses"]), "keyframes": int(fixture["keyframes"]),
           "loop factors": int(fixture["loop_count"][-1]),
           "GPS factors": int(fixture["gps_count"][-1])}
    ref_rec = dict(zip(fixture["recorded_topics"].tolist(),
                       fixture["recorded_counts"].tolist()))
    print(f"bag mission: replayed on the native queues ({feed.native_active}); "
          "counts (port / JAX): " + ", ".join(f"{k} {got[k]} / {ref[k]}" for k in got)
          + f"; full corrections at scans {corrected} (JAX "
          f"{fixture['full_correction_scans'].tolist()}); kernel launches "
          f"{launches} = {map_iters} GN iterations of mapping + {ver_iters} of "
          f"loop verification in {sum(1 for c in cycles if c['iters'])} cycle(s) "
          f"(JAX: {int(fixture['registration_iters'].sum())} of mapping); "
          f"recorded bag {dict(recorded)} (JAX {ref_rec})", flush=True)
    failures = [f"{k} {got[k]}, JAX reference {ref[k]}" for k in got
                if got[k] != ref[k]]
    if corrected != fixture["full_correction_scans"].tolist():
        failures.append(f"full corrections at {corrected}")
    if not np.isfinite(poses).all():
        failures.append("non-finite poses")
    if map_iters == 0 or ver_iters == 0 or launches != map_iters + ver_iters \
            or any(c["launches"] != c["iters"] for c in cycles):
        failures.append(f"kernel launches {launches} != {map_iters} (mapping) "
                        f"+ {ver_iters} (verification)")
    if dict(recorded) != ref_rec or len(odometry) != n:
        failures.append(f"recorded bag {dict(recorded)}, JAX {ref_rec}")
    elif not np.abs(np.stack(odometry) - np.stack(runner.trajectory)[:, 3:]).max() <= 1e-6:
        failures.append("the recorded odometry is not the trajectory")
    if failures:
        fail("; ".join(failures))

    first = min(fixture["full_correction_scans"].tolist() + corrected,
                default=n - 1)
    first_loop = min([c["scan"] for c in cycles if c["iters"]]
                     + [int(s) for s, a in zip(fixture["cycle_scan"],
                                               fixture["loop_accepted"]) if a.any()],
                     default=n - 1)
    failures = deviation_spans("bag mission", poses, fixture["poses"], (
        ("before the first full correction", slice(0, first + 1), MAX_DEV_M,
         MAX_DEV_RAD),
        ("up to the first loop verification", slice(0, first_loop + 1),
         LOOP_GPS_MAX_DEV_M, LOOP_GPS_MAX_DEV_RAD),
        ("whole mission", slice(None), LOOP_MAX_DEV_M, LOOP_MAX_DEV_RAD)))
    p0 = torch.from_numpy(truth.poses[0])
    rel = np.stack([se3.pose6_between(p0, torch.from_numpy(p)).numpy()
                    for p in truth.poses])
    ate = synthetic.ate_rmse(poses, rel)
    print(f"bag mission: ATE {ate:.5f} m against the rebased truth (JAX "
          f"reference {float(fixture['ate_rmse_m']):.5f} m, limit "
          f"{LOOP_MAX_ATE_M} m); mapping_error {runner.mapping_error}", flush=True)
    if not ate <= LOOP_MAX_ATE_M:
        failures.append(f"bag mission: ATE {ate} m")
    if failures:
        fail("; ".join(failures))
    print_intake_times("bag mission", n, seconds, timers, write_s, read_s)
    err = bag_kernel_check(f"bag-mission launch {BAG_CAPTURE_AT}", captured)
    return map_iters, ver_iters, err


def hostile_bag_phase():
    """Phase 13: the hostile bag (bz2 chunks, the Robosense layout, write
    jitter, duplicated IMU messages, an IMU dropout, GPS at 100 Hz), 40
    scans at full width through `replay_bag` into
    `Runner(hostile_bag_config())` on the card, held to the JAX reference
    run.  Returns (kernel launches, the kernel check's largest
    difference)."""
    import shutil
    import tempfile

    import numpy as np

    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm
    from lio_slam_tpu_torch.pipeline.runner import Runner

    fixture = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                                   "bag_mission_jax.npz"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hostile_")
    try:
        path = os.path.join(tmp, "hostile.bag")
        _, write_s = write_bag(path, sm.hostile_bag_kwargs(), fixture, "hostile_")
        runner = Runner(sm.hostile_bag_config())
        results, _, gps, seconds, feed, timers, captured, launches = \
            replay_on_card(runner, path, sm.HOSTILE_TOPICS,
                           HOSTILE_CAPTURE_AT, "hostile_bag")
        read_s = bag_read_seconds(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n = len(results)
    iters = sum(r.registration_iters for r in results)
    is_kf = np.array([r.is_keyframe for r in results])
    ref_kf = fixture["hostile_is_keyframe"]
    print(f"hostile bag: {n} scans (JAX {len(ref_kf)}) on the native queues "
          f"({feed.native_active}); keyframe flags differ at scans "
          f"{np.nonzero(is_kf != ref_kf)[0].tolist() if len(is_kf) == len(ref_kf) else 'all'}; "
          f"GPS factors {gps[-1]} (JAX {int(fixture['hostile_gps_count'][-1])}); "
          f"kernel launches {launches} == GN iterations {iters} (JAX "
          f"{int(fixture['hostile_registration_iters'].sum())})", flush=True)
    poses = np.stack([r.pose for r in results])
    if n != len(ref_kf) or not np.isfinite(poses).all():
        fail(f"hostile bag: {n} scans, finite {bool(np.isfinite(poses).all())}")
    failures = []
    if (is_kf != ref_kf).any() or gps[-1] != int(fixture["hostile_gps_count"][-1]):
        failures.append("hostile bag: keyframe flags or GPS factors differ")
    if launches != iters or launches == 0:
        failures.append(f"hostile bag: {launches} launches, {iters} GN iterations")
    first_gps = min(int(np.argmax(np.asarray(gps) > 0)),
                    int(np.argmax(fixture["hostile_gps_count"] > 0)))
    failures += deviation_spans("hostile bag", poses, fixture["hostile_poses"], (
        ("before the first GPS factor", slice(0, max(first_gps, 1)), MAX_DEV_M,
         MAX_DEV_RAD),
        ("whole mission", slice(None), LOOP_GPS_MAX_DEV_M, LOOP_GPS_MAX_DEV_RAD)))
    if failures:
        fail("; ".join(failures))
    print_intake_times("hostile bag", n, seconds, timers, write_s, read_s)
    err = bag_kernel_check(f"hostile-bag launch {HOSTILE_CAPTURE_AT}", captured)
    return launches, err


def spanned(name, store):
    """A `run_wrapped` wrapper: `timed(store)` around each call inside a
    record_function range `name` (the call's device time in a profiled
    pass)."""
    import torch

    def wrap(fn):
        def ranged(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return timed(store)(ranged)
    return wrap


def capturing(capture_at, captured):
    """A `run_wrapped` wrapper for the kernel's wrapper: the arguments of
    launch number `capture_at`, cloned, appended to `captured`."""
    import torch

    from lio_slam_tpu_torch.ops import fused_corr as fc

    def wrap(kernel):
        def wrapped(*a, **k):
            if fc.KERNEL_LAUNCHES == capture_at:
                captured.append(([x.clone() if isinstance(x, torch.Tensor)
                                  else x for x in a], dict(k)))
            return kernel(*a, **k)
        return wrapped
    return wrap


def corner_mission_phase(mode):
    """Phase 14 (`mode` "incremental") or 15 ("rebuild"): the corner
    mission at full width through `Runner(corner_mission_config(mode))` on
    the card, held to the JAX reference run of the same scans: the scans'
    sha256, the trajectory within the mapping limits, the keyframe count,
    the corners stored per keyframe within 1 %, launches equal to the GN
    iterations, one captured launch against the plain version (the bag
    paths' rule).  Prints scans/s (scans 5-19), the ATE beside the
    reference's, and host and device ms a scan of the corner extraction,
    the corner term and, on the rebuild map, the map assembly and the grid
    build (device time from a profiled pass over scans 20-24).  Returns
    (kernel launches, the kernel check's largest difference)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.ops import registration as reg
    from lio_slam_tpu_torch.ops import voxel_grid as vg
    from lio_slam_tpu_torch.pipeline import keyframes as kf
    from lio_slam_tpu_torch.pipeline import runner as runner_mod
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    rebuild = mode == "rebuild"
    label = "rebuild mission" if rebuild else "corner mission"
    name = "rebuild_mission_jax.npz" if rebuild else "corner_mission_jax.npz"
    fixture = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures", name))
    n = sm.REBUILD_SCANS if rebuild else sm.CORNER_SCANS
    cfg = sm.corner_mission_config(mode)
    t0 = time.perf_counter()
    seq, scans, imus = sm.corner_mission_inputs(cfg, n_scans=n)
    digest = sm.scans_sha256(scans)
    print(f"{label}: {n} sweep scans of {sm.SMOKE_POINTS} points (16 beams, "
          f"1800 azimuth bins) made in {time.perf_counter() - t0:.1f} s on the "
          f"host, sha256 {digest} (the reference replayed "
          f"{fixture['scans_sha256']})", flush=True)
    if digest != str(fixture["scans_sha256"]):
        fail(f"{label}: the scans differ from those the reference replayed")
    runner = runner_mod.Runner(cfg)
    if runner.device.type != "cuda":
        fail(f"Runner(cfg) chose {runner.device}, not the card")

    capture_at = CORNER_CAPTURE_AT[mode]
    captured, host = [], {}

    # the corner term is its line correspondences (the k-NN among the map's
    # corners and the line fits); the rebuild map adds the two assemblies
    # and the grid build of `register_loam`
    spans = [(runner_mod, "extract_corners"), (reg, "find_line_correspondences"),
             (kf, "assemble_corner_map")]
    if rebuild:
        spans += [(kf, "assemble_local_map"), (vg, "build_grid")]
    restore = [run_wrapped(obj, attr, spanned(attr, host.setdefault(attr, [])))
               for obj, attr in spans]
    restore.append(run_wrapped(fc, "fused_ne_from_bucket_ids",
                               capturing(capture_at, captured)))
    results, stamps = [], []
    try:
        zero_launches()
        t0 = time.perf_counter()
        for i in range(20):
            results.append(runner.process_scan(scans[i], imu=imus[i]))
            stamps.append(time.perf_counter())
        torch.cuda.synchronize()
        steady = 15 / (time.perf_counter() - stamps[4])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            p0 = time.perf_counter()
            for i in range(20, 25):
                results.append(runner.process_scan(scans[i], imu=imus[i]))
            torch.cuda.synchronize()
            prof_ms = 1e3 * (time.perf_counter() - p0)
        for i in range(25, n):
            results.append(runner.process_scan(scans[i], imu=imus[i]))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = fc.KERNEL_LAUNCHES
        gn_launches("corner" if mode == "incremental" else "rebuild", launches,
                    sum(r.registration_iters > 0 for r in results))
    finally:
        for undo in restore:
            undo()

    poses = np.stack([r.pose for r in results])
    iters = [r.registration_iters for r in results]
    k = int(runner.state.store.count)
    k_ref = int(fixture["keyframes"])
    corners = runner.state.store.corner_masks[:k].sum(1).cpu().numpy()
    ate = synthetic.ate_rmse(poses, sm.relative_truth(seq))
    print(f"{label}: {n} scans in {elapsed:.3f} s with a profiled pass "
          f"({SMI}); scans 5-19 {steady:.3f} scans/s; keyframes {k} (JAX {k_ref}), "
          f"corners a keyframe {corners.tolist()} (JAX "
          f"{fixture['corners'].tolist()}); kernel launches {launches} == GN "
          f"iterations {sum(iters)} (JAX {int(fixture['registration_iters'].sum())}, "
          f"differing at scans "
          f"{np.nonzero(np.array(iters) - fixture['registration_iters'])[0].tolist()}); "
          f"ATE {ate:.5f} m (JAX reference {float(fixture['ate_rmse_m']):.5f} m)",
          flush=True)
    cuda = torch.autograd.DeviceType.CUDA
    dev_ms = {e.key: 1e-3 * e.device_time_total / 5
              for e in prof.key_averages()
              if e.key in host and e.device_type != cuda}
    per_scan = {span: {"host_ms": round(1e3 * sum(v) / n, 3),
                       "calls": len(v),
                       "device_ms_scans_20_24": round(dev_ms.get(span, 0.0), 3)}
                for span, v in host.items()}
    print(f"{label} times a scan ({SMI}; host: every call of the {n} scans, "
          f"not synchronized, the profiled pass included; device: kernels "
          f"inside the range over the profiled scans 20-24, {prof_ms:.1f} ms "
          f"of wall time): {json.dumps(per_scan)}", flush=True)
    failures = []
    if len(results) != n or not np.isfinite(poses).all():
        failures.append(f"{label}: {len(results)} results, finite "
                        f"{bool(np.isfinite(poses).all())}")
    if k != k_ref:
        failures.append(f"{label}: {k} keyframes, JAX {k_ref}")
    elif not (np.abs(corners - fixture["corners"]) <= 0.01 * fixture["corners"]).all():
        failures.append(f"{label}: corners a keyframe {corners.tolist()}, JAX "
                        f"{fixture['corners'].tolist()} (limit 1 %)")
    if launches != sum(iters) or launches == 0:
        failures.append(f"{label}: {launches} launches, {sum(iters)} GN iterations")
    if not captured:
        failures.append(f"{label}: kernel launch {capture_at} never came")
    failures += deviation_spans(label, poses, fixture["poses"], (
        ("whole mission", slice(None), MAX_DEV_M, MAX_DEV_RAD),))
    if not ate <= 0.2:
        failures.append(f"{label}: ATE {ate} m")
    if failures:
        fail("; ".join(failures))
    err = bag_kernel_check(f"{label} launch {capture_at}", captured[0])
    return launches, err


def operator_calls(fn) -> int:
    """The aten operator calls `fn()` makes (counted by a torch dispatch
    mode)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counting(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Counting() as mode:
        fn()
    return mode.n


def preintegration_phase(dev):
    """Both preintegration forms on the card over one front-end window (64
    samples, 10 valid, 100 Hz): the parallel form held to the sequential
    one at the tolerances of tests/test_preintegration_parallel.py, host ms
    a call (the host's clock, unsynchronized, mean of 20), device ms a call
    (torch.profiler) and operator calls of each."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.ops import preintegration as pre

    rs = np.random.RandomState(0)
    T, valid = 64, 10
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    args = (f32(rs.randn(T, 3) * 0.5 + [0.0, 0.0, 9.80511]),
            f32(rs.randn(T, 3) * 0.3), f32(np.full(T, 0.01)),
            torch.from_numpy(np.arange(T) < valid).to(dev),
            f32(np.zeros(3)), f32(np.zeros(3)), 1e-2, 1e-3)
    out, results = {}, {}
    for name in ("preintegrate", "preintegrate_parallel"):
        fn = getattr(pre, name)
        results[name] = fn(*args)
        ops = operator_calls(lambda: fn(*args))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn(*args)
        host = 1e3 * (time.perf_counter() - t0) / 20
        torch.cuda.synchronize()
        out[name] = {"host_ms": round(host, 4),
                     "device_ms": round(device_ms(lambda: fn(*args), reps=5), 4),
                     "operator_calls": ops}
    seq, par = results["preintegrate"], results["preintegrate_parallel"]
    g = lambda x: x.detach().double().cpu().numpy()
    limits = {"dR": 2e-5, "dv": 2e-4, "dp": 2e-4, "dt": 1e-6,
              **{k: 5e-3 for k in ("dR_dbg", "dv_dbg", "dv_dba", "dp_dbg",
                                   "dp_dba")},
              "cov": 2e-2 * float(g(seq.cov).__abs__().max()) + 1e-10}
    diffs = {k: float(np.abs(g(getattr(par, k)) - g(getattr(seq, k))).max())
             for k in limits}
    print(f"preintegration on the card ({SMI}; a 64-sample window, 10 valid): "
          f"{json.dumps(out)}; parallel - sequential, largest difference: "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in diffs.items()})}",
          flush=True)
    over = [k for k in limits if not diffs[k] <= limits[k]]
    if over:
        fail(f"preintegrate_parallel differs from preintegrate on the card in "
             f"{over}: {[diffs[k] for k in over]}")


def profiling_between(prof, first, last):
    """`run_wrapped` wrappers for a replay's `_prep_predict` and
    `transform_fusion` (the first and the last stage of a scan): the
    profiler `prof` runs from the prep of scan `first` to the end of scan
    `last` (the card synchronized at both ends); the wall time lands in
    `prof.wall_ms`."""
    import torch

    seen = {"prep": 0, "fuse": 0}

    def prep_wrap(fn):
        def wrapped(*a, **k):
            if seen["prep"] == first:
                torch.cuda.synchronize()
                prof.start()
                prof.t0 = time.perf_counter()
            seen["prep"] += 1
            return fn(*a, **k)
        return wrapped

    def fuse_wrap(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            if seen["fuse"] == last:
                torch.cuda.synchronize()
                prof.wall_ms = 1e3 * (time.perf_counter() - prof.t0)
                prof.stop()
            seen["fuse"] += 1
            return out
        return wrapped

    return prep_wrap, fuse_wrap


def hard_replay_phase():
    """Phase 16: `HostDrivenReplay(hard_replay_config(), loop_every=10)` on
    the card over the 60 hard-tier sweep scans, held to
    fixtures/hard_replay_jax.npz: the inputs' sha256, every scan's
    degenerate flag, its GN iterations as `iteration_parting` holds them, the
    trajectory within the mapping limits, the loop count, kernel launches of mapping equal to the GN
    iterations and of loop verification to the reference's verifications,
    one captured launch against the plain version (the bag paths' rule).
    Prints the ATE and mean GN iterations beside RIG_ATE.json's "default"
    row, scans/s over scans 5-59, and from a second replay of scans 0-24
    profiled over scans 20-24 the host and device ms a scan of
    prep+predict, the mapping step and correct+fuse and the device's idle
    share.  Returns (mapping launches, verification launches, the kernel
    check's largest difference)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.pipeline import replay
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    label = "hard replay"
    fixture = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                                   "hard_replay_jax.npz"))
    cfg = sm.hard_replay_config()
    t0 = time.perf_counter()
    seq, batch = sm.hard_replay_inputs(cfg)
    digest = sm.batch_sha256(batch)
    print(f"{label}: {sm.HARD_SCANS} sweep scans of {sm.SMOKE_POINTS} points "
          f"(the default rig: 16 beams, 500 Hz IMU; 2 % garbage, 20000 "
          f"clutter points) made in {time.perf_counter() - t0:.1f} s on the "
          f"host, sha256 {digest} (the reference replayed "
          f"{fixture['batch_sha256']})", flush=True)
    if digest != str(fixture["batch_sha256"]):
        fail(f"{label}: the inputs differ from those the reference replayed")
    hd = replay.HostDrivenReplay(cfg, loop_every=sm.HARD_LOOP_EVERY)
    if hd.device.type != "cuda":
        fail(f"HostDrivenReplay(cfg) chose {hd.device}, not the card")
    scans = hd.split(batch)
    cycles, stamps, captured = [], [], []

    def watching(detector):
        def wrapped(state):
            state, aux = detector(state)
            cycles.append(aux)
            return state, aux
        return wrapped

    def stamping(correct):
        def wrapped(*a, **k):
            out = correct(*a, **k)
            stamps.append(time.perf_counter())
            return out
        return wrapped

    traces = []
    restore = [run_wrapped(hd, "detector", watching),
               run_wrapped(hd, "correct", stamping),
               run_wrapped(fc, "fused_ne_from_bucket_ids",
                           capturing(HARD_CAPTURE_AT, captured))]
    restore += gn_tracing(hd, traces)
    try:
        state, fes = hd.init()
        zero_launches()
        t0 = time.perf_counter()
        state, fes, outs = hd.run(state, fes, scans)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = fc.KERNEL_LAUNCHES
        gn_launches("hard_replay", launches)
    finally:
        for undo in restore:
            undo()

    poses = outs.poses.cpu().numpy()
    iters = outs.iters.cpu().numpy()
    degen = outs.degenerate.cpu().numpy()
    verify_iters = sum(sum(c["loop_iters"]) for c in cycles)
    verifications = sum(len(c["loop_iters"]) for c in cycles)
    ref_verifications = int((fixture["loop_fitness"] != 0).sum())
    mapping = int(iters.sum())
    ate = synthetic.ate_rmse(poses, sm.relative_truth(seq))
    steady = (sm.HARD_SCANS - 5) / (stamps[-1] - stamps[4])
    print(f"{label}: {sm.HARD_SCANS} scans in {elapsed:.3f} s ({SMI}); scans "
          f"5-59 {steady:.3f} scans/s; ATE {ate:.5f} m, mean GN iterations "
          f"(scans 1-59) {iters[1:].mean():.2f} (JAX reference "
          f"{float(fixture['ate_rmse_m']):.5f} m, "
          f"{fixture['registration_iters'][1:].mean():.2f}; RIG_ATE.json "
          f"default row, a JAX record: {RIG_ATE_DEFAULT[0]} m, "
          f"{RIG_ATE_DEFAULT[1]}); kernel launches {launches} = mapping "
          f"{mapping} (JAX {int(fixture['registration_iters'].sum())}) + "
          f"loop verification {verify_iters} in {verifications} "
          f"verification(s) (JAX {ref_verifications}); loops "
          f"{int(state.loop_count)} (JAX {int(fixture['loop_count'])}); "
          f"keyframes {int(state.store.count)} (JAX {int(fixture['keyframes'])})",
          flush=True)
    failures = iteration_parting(label, iters, traces, fixture, cfg)
    if not np.isfinite(poses).all():
        failures.append(f"{label}: non-finite poses")
    if (degen != fixture["degenerate"]).any():
        failures.append(f"{label}: degenerate flags differ at scans "
                        f"{np.nonzero(degen != fixture['degenerate'])[0].tolist()}")
    if int(state.loop_count) != int(fixture["loop_count"]):
        failures.append(f"{label}: {int(state.loop_count)} loops, JAX "
                        f"{int(fixture['loop_count'])}")
    if launches != mapping + verify_iters or mapping == 0:
        failures.append(f"{label}: {launches} launches, {mapping} GN iterations "
                        f"of mapping + {verify_iters} of verification")
    if verifications != ref_verifications:
        failures.append(f"{label}: {verifications} loop verifications, JAX "
                        f"{ref_verifications}")
    if not captured:
        failures.append(f"{label}: kernel launch {HARD_CAPTURE_AT} never came")
    failures += deviation_spans(label, poses, fixture["poses"], (
        ("whole replay", slice(None), MAX_DEV_M, MAX_DEV_RAD),))
    fused = np.abs(outs.fused_last.cpu().numpy() - fixture["fused_last"]).max()
    print(f"{label}: TransformFusion output within {fused:.3e} of the "
          f"reference's", flush=True)
    if failures:
        fail("; ".join(failures))
    err = bag_kernel_check(f"{label} launch {HARD_CAPTURE_AT}", captured[0])
    carried_replay(cfg, scans, fixture)

    # profiled pass: a fresh replay of scans 0-24, profiled over 20-24
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    hd2 = replay.HostDrivenReplay(cfg, loop_every=sm.HARD_LOOP_EVERY)
    host = {}
    prep_wrap, fuse_wrap = profiling_between(prof, 20, 24)
    # (range, attribute): TransformFusion runs after the correction and
    # shares its range
    spans = (("prep_predict", "_prep_predict"), ("mapping_step", "step"),
             ("correct_fuse", "correct"), ("correct_fuse", "transform_fusion"))
    restore = [run_wrapped(hd2, attr, spanned(span, host.setdefault(span, [])))
               for span, attr in spans]
    restore += [run_wrapped(hd2, "_prep_predict", prep_wrap),
                run_wrapped(hd2, "transform_fusion", fuse_wrap)]
    try:
        state, fes = hd2.init()
        hd2.run(state, fes, scans[:25])
    finally:
        for undo in reversed(restore):
            undo()
    cuda = torch.autograd.DeviceType.CUDA
    rows = prof.key_averages()
    dev_ms = {e.key: round(1e-3 * e.device_time_total / 5, 3) for e in rows
              if e.key in host and e.device_type != cuda}
    host_ms = {span: round(1e3 * sum(v[20:25] if span != "correct_fuse"
                                     else v[40:50]) / 5, 3)
               for span, v in host.items()}
    busy = device_busy_ms(rows)
    n_dev = sum(e.count for e in rows if e.device_type == cuda
                and not getattr(e, "is_user_annotation", False))
    print(f"{label} profiled scans 20-24 ({SMI}): host ms a scan "
          f"{json.dumps(host_ms)}, device ms a scan {json.dumps(dev_ms)}; "
          f"device busy {busy:.3f} ms of {prof.wall_ms:.3f} ms wall (idle share "
          f"{1.0 - busy / prof.wall_ms:.3f}); {n_dev / 5:.1f} device kernels "
          f"and copies a scan", flush=True)
    return mapping, verify_iters, err


def gn_tracing(hd, traces):
    """Wrap `hd.step` and `registration._gn_loop` (the fused path, with or
    without the bucket-id refresh) so that `traces` gets a list for each
    scan and each GN loop of that scan appends its trace to it: the (pose,
    inliers) each iteration starts from, then (final pose, -1), left on
    the device until read.  Returns the functions that undo the
    wrapping."""
    from lio_slam_tpu_torch.ops import registration as reg

    def per_scan(step):
        def wrapped(*a, **k):
            traces.append([])
            return step(*a, **k)
        return wrapped

    def tracing(gn_loop):
        def wrapped(*a, ne_fn=None, **k):
            trace = []
            if isinstance(ne_fn, tuple):    # bucket ids held across passes
                bucket_fn, from_ids_fn, refresh = ne_fn

                def from_ids_noting(hh, pose):
                    ne = from_ids_fn(hh, pose)
                    trace.append((pose, ne[2]))
                    return ne
                noting = (bucket_fn, from_ids_noting, refresh)
            else:
                def noting(pose):
                    ne = ne_fn(pose)
                    trace.append((pose, ne[2]))
                    return ne

            res = gn_loop(*a, ne_fn=noting, **k)
            trace.append((res.pose, -1))
            traces[-1].append(trace)
            return res
        return wrapped

    return [run_wrapped(hd, "step", per_scan),
            run_wrapped(reg, "_gn_loop", tracing)]


def gn_steps(poses, rcfg):
    """Each GN step between successive poses over the convergence test's
    thresholds: the larger of the rotation in deg over `rot_converge` and
    the translation in cm over `trans_converge`, a list of floats.  The
    loop stops after the first step under 1."""
    import numpy as np

    d = np.diff(np.asarray(poses, np.float64), axis=0)
    q = np.maximum(np.degrees(np.linalg.norm(d[:, :3], axis=1))
                   / rcfg.rot_converge,
                   100.0 * np.linalg.norm(d[:, 3:], axis=1)
                   / rcfg.trans_converge)
    return [round(float(x), 4) for x in q]


def iteration_parting(label, iters, traces, fixture, cfg):
    """Hold the hard replay's GN iterations to the reference's: at most
    CARRIED_MAX_ITER_DIFF apart on a scan and their sums no further apart
    than the number of scans that differ.  At each scan that differs print
    both packages' GN steps over the convergence thresholds (a step under
    1.0 in both ends the loop) and the inliers of each iteration, the
    reference's from the fixture's GN traces.  Returns the failures."""
    import numpy as np

    rcfg = cfg.registration
    d_it = iters - fixture["registration_iters"]
    differ = np.nonzero(d_it)[0]
    print(f"{label}: GN iterations {int(iters.sum())} (JAX "
          f"{int(fixture['registration_iters'].sum())}), differing at scans "
          f"{differ.tolist()}", flush=True)
    for k in differ:
        n_j, n_p = int(fixture["registration_iters"][k]), int(iters[k])
        trace = traces[k][0]
        ref = gn_steps(fixture["gn_poses"][k, :n_j + 1], rcfg)
        got = gn_steps(np.stack([p.cpu().numpy() for p, _ in trace]), rcfg)
        print(f"{label}: scan {k}, {n_j} iterations in JAX, {n_p} in the "
              f"port; GN steps over the thresholds ({rcfg.rot_converge} deg, "
              f"{rcfg.trans_converge} cm) JAX {ref}, port {got}; inliers JAX "
              f"{fixture['gn_inliers'][k, :n_j].tolist()}, port "
              f"{[int(c) for _, c in trace[:-1]]}", flush=True)
    failures = []
    if np.abs(d_it).max() > CARRIED_MAX_ITER_DIFF:
        failures.append(f"{label}: GN iterations differ by up to "
                        f"{np.abs(d_it).max()} on a scan")
    if abs(int(d_it.sum())) > len(differ):
        failures.append(f"{label}: GN iterations sum {int(iters.sum())}, JAX "
                        f"{int(fixture['registration_iters'].sum())}")
    return failures


def carried_replay(cfg, scans, fixture):
    """Phase 16 again, each scan's prep and correction starting from the
    JAX front-end's state before that scan (recorded in the fixture): the
    mapping path alone against the reference, without the reference's
    float32 error in its first covariance update.  Every scan's degenerate
    flag must be the reference's and its GN iterations as
    `iteration_parting` holds them, the poses within 1e-3 m and 0.005
    deg."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.pipeline import replay
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    hd = replay.HostDrivenReplay(cfg, loop_every=sm.HARD_LOOP_EVERY)

    def substituting(fn):
        """Calls of `fn(fes, ...)` take the reference's state of scan k on
        their k-th call."""
        calls = iter(range(len(scans)))

        def wrapped(fes, *a, **k):
            return fn(fixture_imu_state(fixture, next(calls), hd.device), *a, **k)
        return wrapped

    traces = []
    restore = [run_wrapped(hd, "_prep_predict", substituting),
               run_wrapped(hd, "correct", substituting)]
    restore += gn_tracing(hd, traces)
    try:
        state, fes = hd.init()
        fc.KERNEL_LAUNCHES = 0
        _, _, outs = hd.run(state, fes, scans)
        torch.cuda.synchronize()
        launches = fc.KERNEL_LAUNCHES
    finally:
        for undo in restore:
            undo()
    poses = outs.poses.cpu().numpy()
    iters = outs.iters.cpu().numpy()
    degen = outs.degenerate.cpu().numpy()
    dev_t = float(np.abs(poses[:, 3:] - fixture["poses"][:, 3:]).max())
    dev_r = float(np.abs(poses[:, :3] - fixture["poses"][:, :3]).max())
    print(f"hard replay, carried IMU state: max deviation {dev_t:.3e} m, "
          f"{math.degrees(dev_r):.3e} deg; degenerate flags differ at scans "
          f"{np.nonzero(degen != fixture['degenerate'])[0].tolist()}; "
          f"{launches} kernel launches", flush=True)
    failures = iteration_parting("hard replay, carried IMU state", iters,
                                 traces, fixture, cfg)
    if (degen != fixture["degenerate"]).any():
        failures.append("hard replay with the reference's IMU state: "
                        "degenerate flags differ")
    if failures:
        fail("; ".join(failures))
    if dev_t > CARRIED_MAX_DEV_M or dev_r > CARRIED_MAX_DEV_RAD:
        fail(f"hard replay, carried-state deviation {dev_t} m / {dev_r} rad")
    if launches != int(outs.iters.sum()):
        fail(f"hard replay, carried: {launches} launches, "
             f"{int(outs.iters.sum())} GN iterations")


def deskew_phase():
    """Phase 17: the deskew mission of tests/test_sweep_sensor.py through
    `HostDrivenReplay` on the card, once with the sweep's point times and
    once with zeros: the JAX test's gates (ATE under 0.2 m with deskew,
    at least 4.5 times larger without) and the deskewed ATE within 10 % of
    the reference's (fixtures/hard_replay_jax.npz); launches equal to the
    GN iterations of both runs.  Returns the launches."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.pipeline import replay
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    fixture = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                                   "hard_replay_jax.npz"))
    cfg, seq, windows = sm.deskew_mission_inputs()
    ates, launches, iters = [], 0, 0
    for ptimes in (None, np.zeros_like(seq.ptimes)):
        hd = replay.HostDrivenReplay(cfg, loop_every=0)
        scans = hd.split(sm.replay_batch(seq, windows, ptimes))
        state, fes = hd.init()
        zero_launches()
        _, _, outs = hd.run(state, fes, scans)
        torch.cuda.synchronize()
        launches += fc.KERNEL_LAUNCHES
        gn_launches("deskew", fc.KERNEL_LAUNCHES, int((outs.iters > 0).sum()))
        iters += int(outs.iters.sum())
        ates.append(synthetic.ate_rmse(outs.poses.cpu().numpy(),
                                       sm.relative_truth(seq)))
    with_, without = ates
    ref_with = float(fixture["deskew_ate_with_m"])
    print(f"deskew mission ({SMI}): ATE {with_:.5f} m with point times (JAX "
          f"{ref_with:.5f}), {without:.5f} m without (JAX "
          f"{float(fixture['deskew_ate_without_m']):.5f}), ratio "
          f"{without / with_:.2f} (gate 4.5); kernel launches {launches} == GN "
          f"iterations {iters}", flush=True)
    failures = []
    if not with_ < 0.2:
        failures.append(f"deskewed ATE {with_} m")
    if not without >= 4.5 * with_:
        failures.append(f"deskew off {without} m is not 4.5 x {with_} m")
    if not abs(with_ - ref_with) <= 0.1 * ref_with:
        failures.append(f"deskewed ATE {with_} m, reference {ref_with} m")
    if launches != iters or launches == 0:
        failures.append(f"{launches} launches, {iters} GN iterations")
    if failures:
        fail("deskew mission: " + "; ".join(failures))
    return launches


# ---- phase 18: the sharded mission over torch.distributed ----

SHARDED_DEADLINE_S = 300.0    # a world's ranks, from spawn to their results
SHARDED_MAX_DEV_M = 0.02      # before the correction: the mapping limits
SHARDED_MAX_DEV_RAD = math.radians(0.1)
SHARDED_AFTER_DEV_M = 0.05    # after it: the loop mission's GPS-era limits
SHARDED_AFTER_DEV_RAD = math.radians(0.25)
SHARDED_ROWS_REL = 0.005      # rows a shard against the reference's
SHARDED_PROFILED = 2          # scans profiled after the injected loop
SHARDED_REDUCE_REPS = 200     # (d): reductions timed, staged and flat


def sharded_loop_graph(K, n_loops, dev):
    """tests/test_parallel_sparse.py's `make_loop_graph` (bench.py part 3's
    graph): a noisy straight chain of 1 m steps, `n_loops` loop factors
    i -> i + K/4, a translation-soft prior and K/8 GPS factors."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.graph import factors as F

    rs = np.random.RandomState(0)
    poses = np.zeros((K, 6), np.float32)
    poses[:, 3] = np.arange(K) * 1.0
    poses += rs.randn(K, 6).astype(np.float32) * 0.02
    B = (K - 1) + 64
    meas = np.tile(np.array([0, 0, 0, 1, 0, 0], np.float32), (B, 1))
    bt_i = np.concatenate([np.arange(K - 1), np.zeros(65, np.int64)])[:B]
    bt_j = np.concatenate([np.arange(1, K), np.zeros(65, np.int64)])[:B]
    bt_mask = np.zeros(B, bool)
    bt_mask[:K - 1] = True
    span = K // 4
    for q in range(n_loops):
        s = (K - 1) + q
        i = (q * K // (n_loops + 1)) % (K - span)
        bt_i[s], bt_j[s] = i, i + span
        meas[s] = [0, 0, 0, float(span), 0, 0]
        bt_mask[s] = True
    G = 64
    gps_i, gps_meas = np.zeros(G, np.int32), np.zeros((G, 3), np.float32)
    gps_info, gps_mask = np.zeros((G, 3), np.float32), np.zeros(G, bool)
    for s, i in enumerate(range(0, K, max(K // 8, 1))):
        gps_i[s], gps_meas[s] = i, poses[i, 3:6]
        gps_info[s], gps_mask[s] = 100.0, True
    to = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    info = F.info_from_variances((1e-6, 1e-6, 1e-6, 1e-4, 1e-4, 1e-4))
    return F.empty_graph(K, B, G, device=dev)._replace(
        poses=to(poses), pose_mask=torch.ones(K, dtype=torch.bool, device=dev),
        prior_pose=to(poses[0]),
        prior_info=F.info_from_variances(
            (1e-2, 1e-2, np.pi ** 2, 1e8, 1e8, 1e8)).to(dev),
        bt_i=to(bt_i.astype(np.int32)), bt_j=to(bt_j.astype(np.int32)),
        bt_meas=to(meas), bt_info=info.to(dev)[None].repeat(B, 1),
        bt_mask=to(bt_mask), gps_i=to(gps_i), gps_meas=to(gps_meas),
        gps_info=to(gps_info), gps_mask=to(gps_mask))


def sharded_register_scene(dev):
    """(scan, mask, map, mask, start, truth) on `dev`: the kernel phase's
    8192-point scan and 65536-point map (`scene_points`), started 0.2 m /
    2 deg off the truth, as tests/test_sharding.py starts.  That test's
    four-plane world is not used at this size: 65536 points put about 200
    halo rows into a wall cell's 24 slots, so the single-device register
    starves there while the map split over the ranks keeps more rows a
    cell, and the two land apart for that reason alone."""
    import numpy as np
    import torch

    map_pts, body, pose0 = scene_points()
    init = pose0 + np.array([0.02, 0.01, -0.03, 0.2, -0.15, 0.08], np.float32)
    on = lambda x: torch.from_numpy(np.asarray(x)).to(dev)
    return (on(body), torch.ones(N_SCAN, dtype=torch.bool, device=dev),
            on(map_pts.astype(np.float32)),
            torch.ones(N_MAP, dtype=torch.bool, device=dev), on(init), pose0)


def rank_environment(rank, world, port):
    """The LIO_* variables `distributed.initialize` reads for rank `rank`
    of `world` meeting at 127.0.0.1:`port`; every rank's card is cuda:0."""
    return {"LIO_COORDINATOR": f"127.0.0.1:{port}",
            "LIO_NUM_PROCESSES": str(world), "LIO_PROCESS_ID": str(rank),
            "LOCAL_RANK": "0"}


def sharded_rank(rank, world, backend, port, queue):
    """One rank of phase 18, spawned: its results, or its traceback, go to
    `queue`."""
    import traceback

    try:
        os.environ.update(rank_environment(rank, world, port))
        queue.put((rank, sharded_rank_work(backend, "cuda"), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def sharded_rank_work(backend, device_type):
    """(a) the sharded sparse solver at K=2048 against `solve_sparse`,
    (b) the map-sharded register against the single-device one, (c) the
    sharded `Runner` mission, (d) the two-level mesh's solver, register and
    staged reduction; every rank runs all four (their collectives pair
    up), rank 0's numbers are reported.  The rank joins through
    `distributed.initialize` from the LIO_* variables.  Every tensor lives
    on `device_type` ("cuda": cuda:0; "cpu" for a rehearsal)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    t_begin = time.perf_counter()
    sys.path.insert(0, ROOT)
    from lio_slam_tpu_torch.parallel import distributed as pdist

    on_card = device_type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if on_card else [])
    pdist.initialize(device_type=device_type, backend=backend, timeout_s=120)
    rank, world = dist.get_rank(), dist.get_world_size()
    import dataclasses
    import zlib

    from lio_slam_tpu_torch.config import RegistrationConfig
    from lio_slam_tpu_torch.graph import sparse as gsparse
    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.ops import gn_small as gs
    from lio_slam_tpu_torch.ops import registration as reg
    from lio_slam_tpu_torch.ops import window_system as ws
    from lio_slam_tpu_torch.parallel import mesh as mesh_mod
    from lio_slam_tpu_torch.parallel import multislice as ms
    from lio_slam_tpu_torch.parallel import registration as preg
    from lio_slam_tpu_torch.parallel import sparse as psparse
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm
    from lio_slam_tpu_torch.pipeline.runner import Runner
    from lio_slam_tpu_torch.utils import se3

    mesh = mesh_mod.make_mesh(world, device_type=device_type)
    dev = mesh_mod.mesh_device(mesh)
    t_start = time.perf_counter()
    # seconds of wall time in each part
    parts = {"start-up (imports, process group, mesh)": t_start - t_begin}

    def part_done(name):
        parts[name] = time.perf_counter() - t_begin - sum(parts.values())

    def synced_ms(fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, 1e3 * (time.perf_counter() - t0)

    out = {"world": world, "backend": backend}

    # (a) the column-sharded sparse solver at K=2048; the single-device
    # references run on rank 0 alone (the others wait at the next
    # collective)
    solve = psparse.make_sharded_sparse_solver(mesh)
    g0, g = sharded_loop_graph(2048, 0, dev), sharded_loop_graph(2048, 8, dev)
    got0 = solve(g0, iterations=2).graph.poses
    got, sharded_ms = synced_ms(lambda: solve(g, iterations=5).graph.poses)
    # (b) map-sharded registration: the map split over the ranks
    scan, smask, mp, mmask, init, truth6 = sharded_register_scene(dev)
    cfg_r = RegistrationConfig(degeneracy_eig_thresh=1.0)
    register = preg.make_map_sharded_register(mesh, cfg_r)
    run_sharded = lambda: register(scan, smask,
                                   mesh_mod.shard_points(mesh, mp),
                                   mesh_mod.shard_points(mesh, mmask), init)
    run_sharded()                       # warm: first calls build and cache
    res, reg_ms = synced_ms(run_sharded)
    part_done("sharded solver and register")
    if rank == 0:
        # why the sharded solver linearizes the whole graph on every rank:
        # a batch of half the factors against the same factors in the whole
        from torch.func import vmap

        from lio_slam_tpu_torch.graph import factors as F

        eb, _, _ = F.linearize_between(g)
        h = eb.shape[0] // 2
        e_half = vmap(F._one_between)(g.poses[g.bt_i[:h].long()],
                                      g.poses[g.bt_j[:h].long()],
                                      g.bt_meas[:h])[0]
        batch_bits = [(int((e_half != eb[:h]).sum()), e_half.numel())]
        if world == 1:
            # ... and why Y's column chunks may be split: half the columns
            # against the whole
            D, Loff, _, _, loops = gsparse._assemble(g)
            f = gsparse.tridiag_factor(D, Loff)
            li, lj, Jli, Jlj, _, lmask, nL = loops
            oh = lambda idx: gsparse._one_hot(idx, 2048, torch.float32) \
                * lmask.float()[:, None]
            At = (torch.einsum("lk,lrs->kslr", oh(li), Jli)
                  + torch.einsum("lk,lrs->kslr", oh(lj), Jlj)).reshape(
                      2048, 6, nL * 6)
            Y = gsparse.tridiag_solve(f, At)
            m = nL * 3
            Y_h = gsparse.tridiag_solve(f, At[:, :, :m].contiguous())
            batch_bits.append((int((Y_h != Y[:, :, :m]).sum()), Y_h.numel()))
        ref0 = gsparse.solve_sparse(g0, iterations=2).graph.poses
        ref, single_ms = synced_ms(
            lambda: gsparse.solve_sparse(g, iterations=5).graph.poses)
        truth = torch.zeros((2048, 6), device=dev)
        truth[:, 3] = torch.arange(2048, device=dev)
        out["solver"] = {
            "chain_err": float((got0 - ref0).abs().max()),
            "loop_err": float((got - ref).abs().max()),
            "d_got": float((got - truth).abs().max()),
            "d_ref": float((ref - truth).abs().max()),
            "sharded_ms": sharded_ms, "single_ms": single_ms,
            "batch_bits": batch_bits}
        run_single = lambda: reg.register(scan, smask, mp, mmask, init, cfg_r)
        run_single()
        ref1, single_reg_ms = synced_ms(run_single)
        out["register"] = {
            "err": float((res.pose - ref1.pose).abs().max()),
            "truth_err": float(np.abs(res.pose.cpu().numpy() - truth6).max()),
            "iters": res.iterations, "single_iters": ref1.iterations,
            "ms": reg_ms, "single_ms": single_reg_ms}

    # (c) the sharded Runner: 40 scans, an injected loop, scans until the
    # full correction has run (through the sharded sparse solver)
    cfg = sm.sharded_mission_config(world)
    seq = synthetic.make_sequence(n_scans=sm.SHARDED_SCANS + sm.SHARDED_TAIL,
                                  n_points=sm.SMOKE_POINTS, seed=sm.SMOKE_SEED,
                                  speed=sm.SMOKE_SPEED)
    scans, imus = sm.synthetic_inputs(seq, cfg)
    part_done("single-device references (rank 0) and the mission's inputs")
    runner = Runner(cfg, device=dev, mesh=mesh)
    zero_launches()
    results, stamps = [], []
    for i in range(sm.SHARDED_SCANS):
        results.append(runner.process_scan(scans[i], imu=imus[i]))
        sync()
        stamps.append(time.perf_counter())
    st = runner.state
    n_kf = int(st.store.count)
    meas = se3.pose6_between(st.store.poses[n_kf - 1], st.store.poses[0])
    accepted = runner.inject_loop_constraint(
        n_kf - 1, 0, meas.cpu().numpy(), np.full(6, 1e2, np.float32))
    # the first SHARDED_PROFILED scans after it under torch.profiler (a
    # short pass: the profiler's analysis of a full correction's launches
    # takes longer than the phase), then scans until the correction ran
    i = sm.SHARDED_SCANS
    prof = profile(activities=activities)
    prof.start()
    n_prof = 0
    while not runner.full_correction_scans and i < len(scans):
        results.append(runner.process_scan(scans[i], imu=imus[i]))
        i += 1
        n_prof += 1
        if n_prof == SHARDED_PROFILED:
            break
    sync()
    prof.stop()
    while not runner.full_correction_scans and i < len(scans):
        results.append(runner.process_scan(scans[i], imu=imus[i]))
        i += 1
    sync()
    correction_ms = 1e3 * runner.timer.last().get("full_correction", 0.0)
    tail = i - sm.SHARDED_SCANS
    launches = fc.KERNEL_LAUNCHES
    gn = (gs.KERNEL_LAUNCHES, gs.EIGH_LAUNCHES)
    ws_counts = (ws.KERNEL_LAUNCHES, SAVES[0])
    part_done("mission")
    rows = mesh_mod.all_gather(runner.state.map_grid.counts.sum().to(
        torch.int64), mesh).cpu().numpy()
    # a crc32 of every replicated leaf, gathered: equal rows, equal bits
    sharded = {"map_grid.table", "map_grid.counts", "store.clouds",
               "store.cloud_masks"}

    def crcs(tree, prefix=""):
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return [c for f in tree._fields
                    for c in crcs(getattr(tree, f), f"{prefix}{f}.")]
        if not isinstance(tree, torch.Tensor) or prefix[:-1] in sharded:
            return []
        return [zlib.crc32(tree.detach().cpu().numpy().tobytes())]

    sums = mesh_mod.all_gather(torch.tensor(
        crcs(runner.state) + crcs(runner.imu_state), dtype=torch.int64,
        device=dev), mesh).cpu().numpy()
    # the ranges' host-side rows (their device rows are spans, not work)
    by_key = {e.key: e for e in prof.key_averages()
              if e.device_type != torch.autograd.DeviceType.CUDA}
    per = lambda key, attr: (getattr(by_key[key], attr) * 1e-3 / n_prof
                             if key in by_key else 0.0)
    part_done("profile analysis and checksums")
    out["mission"] = {
        "poses": np.stack([r.pose for r in results]),
        "is_keyframe": np.array([r.is_keyframe for r in results]),
        "iters": np.array([r.registration_iters for r in results]),
        "keyframes_before": n_kf, "keyframes": int(runner.state.store.count),
        "accepted": bool(accepted),
        "correction_scans": list(runner.full_correction_scans),
        "launches": launches, "gn": gn, "ws": ws_counts, "rows": rows,
        "checksums": sums,
        "scans_per_s": (sm.SHARDED_SCANS - 5) / (stamps[-1] - stamps[4]),
        "tail": tail, "profiled_scans": n_prof,
        "mapping_host_ms": per("mapping_step", "cpu_time_total"),
        "mapping_device_ms": per("mapping_step", "device_time_total"),
        "collective_host_ms": per("collective:psum", "cpu_time_total")
        + per("collective:all_gather", "cpu_time_total"),
        "collective_device_ms": per("collective:psum", "device_time_total")
        + per("collective:all_gather", "device_time_total"),
        "collective_calls": sum(by_key[k].count for k in
                                ("collective:psum", "collective:all_gather")
                                if k in by_key) / n_prof,
        "correction_ms": correction_ms,
        "table_shape": tuple(runner.state.map_grid.table.shape)}
    # (d) the two-level mesh, one slice a process: the multislice solver on
    # (a)'s graphs, the multislice register on (b)'s scene, the staged
    # reduction against one over the whole group; none launches a kernel
    gmesh = pdist.global_mesh(devices_per_slice=1, device_type=device_type)
    zero_launches()
    ms_solve = ms.make_multislice_solver(gmesh)
    ms_got0 = ms_solve(g0, g0.pose_mask, iterations=2).poses
    ms_got, ms_solver_ms = synced_ms(
        lambda: ms_solve(g, g.pose_mask, iterations=5).poses)
    placed = (pdist.factor_sharded(gmesh, scan.cpu().numpy()),
              pdist.factor_sharded(gmesh, np.ones(N_SCAN, bool)),
              pdist.replicated(gmesh, mp.cpu().numpy()),
              pdist.replicated(gmesh, np.ones(N_MAP, bool)),
              pdist.replicated(gmesh, init.cpu().numpy()))
    ms_register = ms.make_multislice_register(gmesh, cfg_r)
    warm = ms_register(*placed)
    ms_res, ms_reg_ms = synced_ms(lambda: ms_register(*placed))
    prof = profile(activities=activities)
    prof.start()
    profiled = ms_register(*placed)
    sync()
    prof.stop()
    # the three registers' GN passes, and gn_small's launches over them
    gn = (gs.KERNEL_LAUNCHES, gs.EIGH_LAUNCHES)
    ws_counts = (ws.KERNEL_LAUNCHES, SAVES[0])
    gn_passes = sum(int(r.iterations) for r in (warm, ms_res, profiled))
    psum_rows = [e for e in prof.key_averages()
                 if e.key == "collective:psum"
                 and e.device_type != torch.autograd.DeviceType.CUDA]
    x = torch.arange(45, dtype=torch.float32, device=dev) * (rank + 1)
    staged = ms.psum_staged(x, gmesh)
    flat = x.clone()
    dist.all_reduce(flat)

    def flat_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y

    reduce_ms = {}
    for name, fn in (("staged", lambda: ms.psum_staged(x, gmesh)),
                     ("flat", flat_reduce)):
        fn()
        _, t = synced_ms(lambda: [fn() for _ in range(SHARDED_REDUCE_REPS)])
        reduce_ms[name] = t / SHARDED_REDUCE_REPS
    d = {"mesh": tuple(gmesh.mesh.shape),
         "shard_rows": int(placed[0].shape[0]),
         "launches": fc.KERNEL_LAUNCHES, "gn": gn, "ws": ws_counts,
         "gn_passes": gn_passes,
         "solver_ms": ms_solver_ms, "reg_ms": ms_reg_ms,
         "iters": int(ms_res.iterations),
         "psum_calls": psum_rows[0].count if psum_rows else 0,
         "psum_host_ms": (psum_rows[0].cpu_time_total * 1e-3
                          if psum_rows else 0.0),
         "psum_device_ms": (psum_rows[0].device_time_total * 1e-3
                            if psum_rows else 0.0),
         "bit_equal": bool(torch.equal(staged, flat)),
         "staged_ms": reduce_ms["staged"], "flat_ms": reduce_ms["flat"]}
    if rank == 0:
        d.update(chain_err=float((ms_got0 - ref0).abs().max()),
                 loop_err=float((ms_got - ref).abs().max()),
                 d_got=float((ms_got - truth).abs().max()),
                 d_ref=float((ref - truth).abs().max()),
                 single_ms=single_ms,
                 reg_err=float((ms_res.pose - ref1.pose).abs().max()),
                 truth_err=float(np.abs(ms_res.pose.cpu().numpy()
                                        - truth6).max()),
                 single_iters=int(ref1.iterations),
                 single_reg_ms=single_reg_ms)
    out["multislice"] = d
    part_done("multislice (d)")
    out["parts"] = parts
    dist.barrier()
    dist.destroy_process_group()
    return out


def free_port() -> int:
    """A TCP port no socket holds now (another process may take it before
    rank 0 binds it: `run_world` then spawns once more)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_world(world, backend):
    """Spawn `world` ranks of phase 18 on cuda:0 and return rank 0's
    results; a rank's failure or the deadline fails the run.  A rendezvous
    whose port another process took (the address in use) is spawned once
    more on a fresh port, and says so."""
    error, got = spawn_world(world, backend)
    if error is not None and "address already in use" in error.lower():
        print(f"phase 18, world {world}: the rendezvous port was taken; "
              "spawning the ranks again on a fresh port", flush=True)
        error, got = spawn_world(world, backend)
    if error is not None:
        fail(f"phase 18, world {world} on {backend}: {error}")
    return got[0]


def spawn_world(world, backend):
    """(error or None, {rank: results}) of one spawn of `world` ranks."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=sharded_rank,
                         args=(r, world, backend, port, q))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARDED_DEADLINE_S
    got, error = {}, None
    try:
        while len(got) < world and error is None:
            left = deadline - time.monotonic()
            if left <= 0:
                error = f"deadline of {SHARDED_DEADLINE_S:.0f} s passed"
                break
            try:
                rank, res, tb = q.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    error = f"a rank exited with {dead}"
                continue
            if tb is not None:
                error = f"rank {rank} failed:\n{tb}"
            got[rank] = res
        for p in procs:
            p.join(timeout=30 if error is None else 0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return error, got


def check_sharded(res, fixture):
    """Phase 18's gates on rank 0's results of one world."""
    import numpy as np

    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    D, be = res["world"], res["backend"]
    tag = f"phase 18 (world {D}, {be})"
    s = res["solver"]
    print(f"{tag}: sharded sparse solver K=2048: chain-only {s['chain_err']:.3e} "
          f"from solve_sparse (limit 1e-4); with loops {s['loop_err']:.3e} "
          f"(limit 5e-2), {s['d_got']:.4f} from truth against "
          f"{s['d_ref']:.4f}; 5 iterations {s['sharded_ms']:.3f} ms sharded, "
          f"{s['single_ms']:.3f} ms solve_sparse ({SMI})", flush=True)
    bits = s["batch_bits"]
    print(f"{tag}: computed for half the batch against the whole graph: "
          f"the between factors' residuals differ in {bits[0][0]} of "
          f"{bits[0][1]}"
          + (f"; the columns of Y = T⁻¹Aᵀ solved in two halves against "
             f"all at once: {bits[1][0]} of {bits[1][1]} differ"
             if len(bits) > 1 else ""), flush=True)
    if not (s["chain_err"] < 1e-4 and s["loop_err"] < 5e-2
            and s["d_got"] <= s["d_ref"] * 1.1 + 1e-3):
        fail(f"{tag}: sharded sparse solver {s}")
    r = res["register"]
    print(f"{tag}: map-sharded register, {N_SCAN} scan points against a "
          f"{N_MAP}-point map: {r['err']:.3e} from the single-device register "
          f"(limit 5e-3), {r['truth_err']:.3e} from truth; {r['iters']} GN "
          f"iterations ({r['single_iters']} single); {r['ms']:.3f} ms "
          f"({r['single_ms']:.3f} ms single, fused kernel) ({SMI})", flush=True)
    if not (r["err"] <= 5e-3 and r["truth_err"] < 0.02):
        fail(f"{tag}: map-sharded register {r}")
    m = res["mission"]
    key = lambda k: fixture[f"d{D}_{k}"]
    poses, ref = m["poses"], key("poses")
    n = sm.SHARDED_SCANS
    if poses.shape != ref.shape:
        fail(f"{tag}: {len(poses)} scans, reference {len(ref)}")
    dev_b = (float(np.abs(poses[:n, 3:] - ref[:n, 3:]).max()),
             float(np.abs(poses[:n, :3] - ref[:n, :3]).max()))
    dev_a = (float(np.abs(poses[n:, 3:] - ref[n:, 3:]).max()),
             float(np.abs(poses[n:, :3] - ref[n:, :3]).max()))
    rows_ref = key("rows")
    rows_rel = np.abs(m["rows"] - rows_ref) / np.maximum(rows_ref, 1)
    same_sums = bool((m["checksums"] == m["checksums"][0]).all())
    print(f"{tag}: Runner mission, {n} scans + {m['tail']} "
          f"after the injected loop: {m['scans_per_s']:.3f} scans/s over "
          f"scans 5-39; deviation from the JAX reference {dev_b[0]:.3e} m / "
          f"{math.degrees(dev_b[1]):.3e} deg before the correction, "
          f"{dev_a[0]:.3e} m / {math.degrees(dev_a[1]):.3e} deg after; "
          f"keyframes {m['keyframes_before']} -> {m['keyframes']} (JAX "
          f"{int(key('keyframes_before'))} -> {int(key('keyframes'))}); "
          f"full correction at scan {m['correction_scans']} (JAX "
          f"{int(key('correction_scan'))}); rows a shard {m['rows'].tolist()} "
          f"(JAX {rows_ref.tolist()}); a table of {m['table_shape'][0]} "
          f"buckets a rank; replicated leaves equal on every rank: "
          f"{same_sums}; fused_corr launches {m['launches']}", flush=True)
    print(f"{tag}: profiled scans {n}-{n + m['profiled_scans'] - 1}: "
          f"mapping step {m['mapping_host_ms']:.3f} host ms / "
          f"{m['mapping_device_ms']:.3f} device ms a scan; collectives "
          f"{m['collective_calls']:.1f} calls, {m['collective_host_ms']:.3f} "
          f"host ms / {m['collective_device_ms']:.3f} device ms a scan; the "
          f"full correction (the sharded sparse solver, K=256, and the "
          f"rebuild) {m['correction_ms']:.3f} host ms, its stage timer "
          f"({SMI})", flush=True)
    if not np.isfinite(poses).all():
        fail(f"{tag}: non-finite poses")
    if dev_b[0] > SHARDED_MAX_DEV_M or dev_b[1] > SHARDED_MAX_DEV_RAD:
        fail(f"{tag}: {dev_b} from the reference before the correction")
    if dev_a[0] > SHARDED_AFTER_DEV_M or dev_a[1] > SHARDED_AFTER_DEV_RAD:
        fail(f"{tag}: {dev_a} from the reference after the correction")
    if (m["keyframes_before"], m["keyframes"]) != (
            int(key("keyframes_before")), int(key("keyframes"))):
        fail(f"{tag}: keyframe counts differ from the reference")
    if not m["accepted"] or m["correction_scans"] != [int(key("correction_scan"))]:
        fail(f"{tag}: the full correction ran at {m['correction_scans']}")
    if (rows_rel > SHARDED_ROWS_REL).any():
        fail(f"{tag}: rows a shard {m['rows']} against {rows_ref}")
    print(f"{tag}: rank 0's wall time in s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in res["parts"].items()),
          flush=True)
    if not same_sums:
        fail(f"{tag}: the ranks' replicated leaves differ")
    if m["launches"]:
        fail(f"{tag}: the sharded mapping path launched fused_corr")
    gn_launches(f"sharded_mission_world{D}", int(m["iters"].sum()),
                int((m["iters"] > 0).sum()), counts=m["gn"],
                ws_counts=m["ws"])
    d = res["multislice"]
    print(f"{tag} (d): global_mesh {d['mesh']} (\"slice\", \"data\"); "
          f"multislice solver K=2048: chain-only {d['chain_err']:.3e} from "
          f"solve_sparse (limit 1e-4); with loops {d['loop_err']:.3e} (limit "
          f"5e-2), {d['d_got']:.4f} from truth against {d['d_ref']:.4f}; 5 "
          f"iterations {d['solver_ms']:.3f} ms ({d['single_ms']:.3f} ms "
          f"solve_sparse) ({SMI})", flush=True)
    print(f"{tag} (d): multislice register, {d['shard_rows']} of {N_SCAN} "
          f"scan points a rank against the whole {N_MAP}-point map: "
          f"{d['reg_err']:.3e} from the single-device register (limit 5e-3), "
          f"{d['truth_err']:.3e} from truth (limit 0.02); {d['iters']} GN "
          f"iterations ({d['single_iters']} single); {d['reg_ms']:.3f} ms "
          f"({d['single_reg_ms']:.3f} ms single, fused kernel); staged "
          f"reductions {d['psum_calls']} calls, {d['psum_host_ms']:.3f} host "
          f"ms / {d['psum_device_ms']:.3f} device ms in one call of the register "
          f"(torch.profiler) ({SMI})", flush=True)
    print(f"{tag} (d): 45 float32 values reduced over the mesh, staged "
          f"(\"data\" then \"slice\") {d['staged_ms']:.4f} ms against one "
          f"all_reduce over the group {d['flat_ms']:.4f} ms (mean of "
          f"{SHARDED_REDUCE_REPS}); bit-equal on integer values: "
          f"{d['bit_equal']}; fused_corr launches in (d) {d['launches']} "
          f"({SMI})", flush=True)
    if d["mesh"] != (D, 1):
        fail(f"{tag} (d): global_mesh {d['mesh']}, not ({D}, 1)")
    if not (d["chain_err"] < 1e-4 and d["loop_err"] < 5e-2
            and d["d_got"] <= d["d_ref"] * 1.1 + 1e-3):
        fail(f"{tag} (d): multislice solver {d}")
    if not (d["reg_err"] <= 5e-3 and d["truth_err"] < 0.02):
        fail(f"{tag} (d): multislice register {d}")
    if d["psum_calls"] != d["iters"]:
        fail(f"{tag} (d): {d['psum_calls']} staged reductions in a register "
             f"of {d['iters']} GN iterations")
    if not d["bit_equal"]:
        fail(f"{tag} (d): psum_staged differs from the flat reduction")
    if d["launches"]:
        fail(f"{tag} (d): the multislice paths launched fused_corr")
    gn_launches(f"multislice_register_world{D}", d["gn_passes"], 3,
                counts=d["gn"], ws_counts=d["ws"])


def sharded_phase():
    """Phase 18 at world 1 on NCCL and world 2 on gloo, both on cuda:0
    (NCCL refuses two ranks on one card)."""
    import numpy as np

    fixture = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                                   "sharded_mission_jax.npz"))
    for world, backend in ((1, "nccl"), (2, "gloo")):
        t0 = time.perf_counter()
        check_sharded(run_world(world, backend), fixture)
        print(f"phase 18 world {world} ({backend}): "
              f"{time.perf_counter() - t0:.1f} s wall", flush=True)


# ---- phase 19: the device-resident replay programs as CUDA graphs ----

PIPELINE_TAP_PASS = 1   # GN pass whose kernel launch phase 19 taps in graph (a)
PROFILED_SCANS = 5      # scans of phase 19's profiled chunk (20 on)


def step_clock(label):
    """`mark(step)` prints the host seconds since the previous mark (or
    since this call), so a phase shows where its wall time went."""
    last = [time.perf_counter()]

    def mark(step):
        now = time.perf_counter()
        print(f"{label}: {step} {now - last[0]:.1f} s", flush=True)
        last[0] = now
    return mark


def graph_tap(at, store):
    """A `run_wrapped` wrapper for the kernel's wrapper: at its call number
    `at` (counted from 0 by the wrapper itself), copies of the arguments and
    of the five results appended to `store`.  Called while a CUDA graph is
    captured, the copies are nodes of that graph, so after each replay they
    hold what that launch saw and wrote there."""
    import torch

    calls = [0]

    def wrap(kernel):
        def wrapped(*a, **k):
            out = kernel(*a, **k)
            if calls[0] == at:
                store.append(([x.clone() if isinstance(x, torch.Tensor) else x
                               for x in a], dict(k),
                              [x.clone() for x in out]))
            calls[0] += 1
            return out
        return wrapped
    return wrap


def sync_free(run):
    """Wrap `run.detector` and `run.full_correct` (the cadence calls, whose
    work is sized on the host) so that the sync debug mode is off inside
    them and as it was after; returns the undo functions."""
    import torch

    def quiet(fn):
        def wrapped(*a, **k):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return wrapped

    return [run_wrapped(run, "detector", quiet),
            run_wrapped(run, "full_correct", quiet)]


def no_sync(fn, *a):
    """`fn(*a)` with `torch.cuda.set_sync_debug_mode("error")`: a read of
    the card from the host (outside the cadence calls, see `sync_free`)
    fails the phase."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*a)
    except RuntimeError as exc:
        fail(f"a device synchronization inside a replay: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)


def scan_events(prog):
    """Wrap `prog.finish_scan` so that a CUDA event is recorded after each
    scan (no wait); returns (events, undo)."""
    import torch

    events = []

    def wrap(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            return out
        return wrapped
    return events, run_wrapped(prog, "finish_scan", wrap)


def steady_rate(events, first, last):
    """Scans a second between the ends of scans `first` and `last`."""
    events[last].synchronize()
    return (last - first) / (1e-3 * events[first].elapsed_time(events[last]))


def graph_ms(fn, reps=20):
    """ms of one replay of `fn` captured as a CUDA graph: CUDA events
    around `reps` back-to-back replays, after a warm-up on the capture
    stream.  A graph of tiny kernels takes their durations and the gaps
    between its nodes, as the replay's own graphs do."""
    import torch

    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.ops import gn_small as gs
    from lio_slam_tpu_torch.ops import window_system as ws

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fc.prepare_stream(torch.device("cuda", torch.cuda.current_device()))
        fn()
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n0 = fc.CAPTURED_LAUNCHES
    g0 = gs.CAPTURED_LAUNCHES, gs.CAPTURED_EIGH_LAUNCHES
    w0 = ws.CAPTURED_LAUNCHES
    with torch.cuda.graph(graph, stream=side):
        fn()
    held = fc.CAPTURED_LAUNCHES - n0
    gn_held = (gs.CAPTURED_LAUNCHES - g0[0], gs.CAPTURED_EIGH_LAUNCHES - g0[1])
    ws_held = ws.CAPTURED_LAUNCHES - w0
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    fc.KERNEL_LAUNCHES += held * (reps + 1)
    gs.KERNEL_LAUNCHES += gn_held[0] * (reps + 1)
    gs.EIGH_LAUNCHES += gn_held[1] * (reps + 1)
    ws.KERNEL_LAUNCHES += ws_held * (reps + 1)
    return a.elapsed_time(b) / reps


def resident_costs(run, batch, state, fes, iters, is_kf_share):
    """What the resident design costs a scan, measured on the program
    itself: `make_lio_step(resident=True)` captured as a CUDA graph on the
    replay's final state and its last scan, each variant timed by
    `graph_ms`.  The dead GN passes: the step at `max_iterations` against
    the step at the mean iterations rounded up, per pass, times
    (max_iterations - mean iterations).  The masked keyframe save: the step
    with the keyframe gate forced down against the same step with the save
    left out, times the share of scans that are no keyframe.  Returns (ms
    a pass, ms of one masked save, the dead passes' ms a scan, the masked
    saves' ms a scan)."""
    import dataclasses

    import numpy as np
    import torch

    from lio_slam_tpu_torch.pipeline import lio
    from lio_slam_tpu_torch.pipeline import replay

    cfg = run.cfg
    r = cfg.registration
    R = r.max_iterations
    s = replay.ReplayBatch(*(a[-1] for a in batch))
    sin, _, _ = replay.prep_predict(cfg, run.program.predict_rate, fes, s)

    def step_ms(max_iterations):
        c = dataclasses.replace(cfg, registration=dataclasses.replace(
            r, max_iterations=max_iterations))
        step = lio.make_lio_step(c, device=run.device, resident=True)
        return graph_ms(lambda: step(state, sin))

    mean = float(np.mean(iters))
    m = min(R, math.ceil(mean))
    full = step_ms(R)
    pass_ms = (full - step_ms(m)) / (R - m) if m < R else 0.0
    no = torch.zeros((), dtype=torch.bool, device=run.device)
    restore = [run_wrapped(lio.kf, "should_add_keyframe",
                           lambda fn: lambda *a, **k: no)]
    try:
        gated = step_ms(R)
        restore.append(run_wrapped(lio, "_save_keyframe",
                                   lambda fn: lambda st, *a, **k: st))
        save_ms = gated - step_ms(R)
    finally:
        for undo in reversed(restore):
            undo()
    return pass_ms, save_ms, pass_ms * (R - mean), save_ms * (1.0 - is_kf_share)


def watched_detector(run, cycles):
    """Wrap `run.detector` so that each cycle's aux lands in `cycles`;
    returns the undo function."""
    def watching(detector):
        def wrapped(state):
            state, aux = detector(state)
            cycles.append(aux)
            return state, aux
        return wrapped
    return run_wrapped(run, "detector", watching)


def check_replay_launches(label, launches, n_scans, R, cycles):
    """The kernel launches counted over a resident replay's run, held to
    R a scan (every GN pass of the graph launches the kernel) plus the GN
    iterations of the cadence calls' loop verifications.  Returns (the
    verification launches, the failures)."""
    verify = sum(sum(c["loop_iters"]) for c in cycles)
    want = R * n_scans + verify
    print(f"{label}: kernel launches in the run {launches} = {R} x {n_scans} "
          f"scans from the graphs + {verify} of loop verification "
          f"(expected {want})", flush=True)
    if launches != want:
        return verify, [f"{label}: {launches} kernel launches, {want} "
                        "expected"]
    return verify, []


def host_driven_run(hd, scans):
    """(outputs, steady scans/s over the scans from the fifth on) of
    `HostDrivenReplay` `hd` over `scans`, a CUDA event recorded after each
    scan's TransformFusion."""
    import torch

    events = []

    def after_fusion(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            return out
        return wrapped

    undo = run_wrapped(hd, "transform_fusion", after_fusion)
    try:
        _, _, outs = hd.run(*hd.init(), scans)
    finally:
        undo()
    return outs, steady_rate(events, 4, len(events) - 1)


def profiled_chunk(run, staged, lo, hi):
    """(device busy ms, wall ms, fused_corr kernels and all device kernels
    and copies in the profile, kernel launches counted) of scans lo..hi-1
    of a resident replay under torch.profiler, after an unprofiled replay
    of scans 0..lo-1.  A pass whose trace kept fewer than 95 % of the
    fused_corr launches counted (the tracer drops records, now and then a
    whole pass's) is made again, three times at most; the caller checks
    the last."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.pipeline import replay

    part = lambda a, b: replay.ReplayBatch(*(x[a:b] for x in staged))
    for _ in range(3):
        restore = sync_free(run)
        try:
            st, fs, o = run(*run.init(), part(0, lo))
            last = o.poses[-1].clone()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fc.KERNEL_LAUNCHES = 0
                run(st, fs, part(lo, hi), last)
                counted = fc.KERNEL_LAUNCHES
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
        finally:
            for undo in reversed(restore):
                undo()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        fused = sum(e.count for e in rows if "fused_corr" in e.key)
        if 0.95 * counted <= fused <= counted:
            break
        print(f"profiled_chunk: the profiler saw {fused} of {counted} "
              "fused_corr launches; profiling again", flush=True)
    return (device_busy_ms(rows), wall_ms, fused, sum(e.count for e in rows),
            counted)


def pipeline_replay_phase():
    """Phase 19 (a): bench.py part 1b's inputs (`bench_config()`, 120 scans
    of 32768 points, 64-sample IMU windows) through
    `make_pipeline_replay(loop_every=10)`, each scan two CUDA graphs, and
    through `HostDrivenReplay` in the same process.  Returns (the kernel
    launches of the timed run, counted as the graphs replay them, the
    fused_corr kernels the profiler saw in a replayed 5-scan chunk, the
    kernel check's largest difference)."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.pipeline import replay
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    label = "pipeline replay"
    mark = step_clock(label)
    fixture = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                                   "pipeline_replay_jax.npz"))
    cfg = sm.bench_config()
    seq, batch = sm.pipeline_replay_inputs()
    digest = sm.batch_sha256(batch)
    print(f"{label}: {sm.PIPELINE_REPLAY_SCANS} scans of {sm.SMOKE_POINTS} "
          f"points, sha256 {digest} (the reference replayed "
          f"{fixture['batch_sha256']})", flush=True)
    if digest != str(fixture["batch_sha256"]):
        fail(f"{label}: the inputs differ from those the reference replayed")

    # the eager replay, on the same inputs
    hd = replay.HostDrivenReplay(cfg, loop_every=sm.LOOP_EVERY)
    scans = hd.split(batch)
    mark("inputs made and staged")
    eager, hd_rate = host_driven_run(hd, scans)
    mark("host-driven replay")

    run = replay.make_pipeline_replay(cfg, loop_every=sm.LOOP_EVERY)
    if run.device.type != "cuda":
        fail(f"make_pipeline_replay(cfg) chose {run.device}, not the card")
    staged = run.stage(batch)
    tapped = []
    R = cfg.registration.max_iterations
    # the wrapper is called 2 x R times in the warm-up, then R times in the
    # capture of graph (a): tap pass PIPELINE_TAP_PASS of the capture
    undo = run_wrapped(fc, "fused_ne_from_bucket_ids",
                       graph_tap(2 * R + PIPELINE_TAP_PASS, tapped))
    try:
        state, fes = run.init()
        run.capture(state, fes, staged)
    finally:
        undo()
    mark("capture")
    events, undo_ev = scan_events(run.program)
    cycles = []
    restore = sync_free(run) + [undo_ev, watched_detector(run, cycles)]
    try:
        state, fes = run.init()
        t0 = time.perf_counter()
        zero_launches()
        state, fes, outs = no_sync(run, state, fes, staged)
        launches = fc.KERNEL_LAUNCHES
        gn_launches("pipeline_replay", launches,
                    graph_scans=outs.poses.shape[0])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        for undo in reversed(restore):
            undo()
    graph_rate = steady_rate(events, 4, len(events) - 1)
    mark("graph replay")

    poses = outs.poses.cpu().numpy()
    iters = outs.iters.cpu().numpy()
    degen = outs.degenerate.cpu().numpy()
    e_poses = eager.poses.cpu().numpy()
    truth = sm.relative_truth(seq)
    drift = float(np.linalg.norm(poses[-1, 3:] - truth[-1, 3:]))
    print(f"{label} ({SMI}): capture {run.capture_seconds:.3f} s (warm-up "
          f"included); {len(poses)} scans in {elapsed:.3f} s; scans "
          f"5-{len(poses) - 1} {graph_rate:.3f} scans/s as CUDA graphs, "
          f"{hd_rate:.3f} scans/s "
          f"host-driven (the same process); GN iterations {int(iters.sum())} "
          f"(host-driven {int(eager.iters.sum())}, JAX "
          f"{int(fixture['registration_iters'].sum())}); drift {drift:.4f} m "
          f"(JAX {float(fixture['drift_m']):.4f} m, bench.py's limit 3 m); "
          f"keyframes {int(state.store.count)} (JAX "
          f"{int(fixture['keyframes'])}); fused_corr nodes of graphs (a), "
          f"(b): {run.program.graph_launches}", flush=True)
    _, failures = check_replay_launches(label, launches, len(outs.iters), R,
                                        cycles)
    if not np.isfinite(poses).all():
        failures.append(f"{label}: non-finite poses")
    if not np.array_equal(iters, eager.iters.cpu().numpy()):
        failures.append(f"{label}: GN iterations differ from the host-driven "
                        f"replay at scans "
                        f"{np.nonzero(iters != eager.iters.cpu().numpy())[0].tolist()}")
    if not np.array_equal(degen, eager.degenerate.cpu().numpy()):
        failures.append(f"{label}: degenerate flags differ from the "
                        "host-driven replay")
    d_hd = float(np.abs(poses - e_poses).max())
    print(f"{label}: poses "
          f"{'bit-equal to' if d_hd == 0 else f'within {d_hd:.3e} of'} the "
          f"host-driven replay's; TransformFusion within "
          f"{float(np.abs(outs.fused_last.cpu().numpy() - eager.fused_last.cpu().numpy()).max()):.3e}",
          flush=True)
    if d_hd > 1e-5:
        failures.append(f"{label}: poses {d_hd} from the host-driven replay's")
    d_it = iters - fixture["registration_iters"]
    print(f"{label}, free-running: GN iterations differ from JAX's at "
          f"{np.count_nonzero(d_it)} scans, by up to {np.abs(d_it).max()} "
          f"(sums {int(iters.sum())} / "
          f"{int(fixture['registration_iters'].sum())}); held below with the "
          f"reference's IMU state carried in, as phase 4 holds the mission",
          flush=True)
    if (degen != fixture["degenerate"]).any():
        failures.append(f"{label}: degenerate flags differ from JAX's")
    failures += deviation_spans(label, poses, fixture["poses"], (
        ("whole replay", slice(None), MAX_DEV_M, MAX_DEV_RAD),))
    if not drift <= 3.0:
        failures.append(f"{label}: drift {drift} m")
    if not tapped:
        failures.append(f"{label}: no launch tapped in the capture")
    if failures:
        fail("; ".join(failures))

    carried_pipeline_replay(run, staged, fixture, hd, scans)
    mark("carried graph replay")

    # the kernel on the arguments of a launch inside graph (a), as the last
    # replayed scan left them; and the graph's own results of that launch
    args, kw, graph_out = tapped[0]
    err = bag_kernel_check(f"{label} graph (a), pass {PIPELINE_TAP_PASS} of "
                           "the last scan", (args, kw))
    check_ne(f"{label} graph (a)'s own results of that launch", graph_out,
             fc.fused_ne_from_bucket_ids_ref(*args, **kw))
    mark("kernel checks")

    # a profiled chunk: scans 20-24 after a replay of scans 0-19
    busy, wall_ms, fused, n_dev, counted = profiled_chunk(
        run, staged, 20, 20 + PROFILED_SCANS)
    # no keyframe is evicted at K=256: the store holds every keyframe saved
    mark("profiled chunk")
    pass_ms, save_ms, dead_ms, masked_ms = resident_costs(
        run, staged, state, fes, iters, int(state.store.count) / len(iters))
    n = PROFILED_SCANS
    print(f"{label} profiled chunk, scans 20-{19 + n} ({SMI}): device "
          f"{busy / n:.3f} ms a scan, busy {busy:.3f} ms of {wall_ms:.3f} ms "
          f"wall (idle share {1.0 - busy / wall_ms:.3f}); {n_dev / n:.1f} "
          f"device kernels and copies a scan; fused_corr launches {fused} "
          f"({fused / n:.1f} a scan, {R} by design; {counted} counted); "
          f"unprofiled, the graphs "
          f"ran scans 5-119 at {1e3 / graph_rate:.3f} ms a scan, "
          f"{busy / n:.3f} ms of it busy (idle share "
          f"{1.0 - busy / n * graph_rate / 1e3:.3f}); one resident GN pass "
          f"{pass_ms:.3f} ms as a graph, the dead passes {dead_ms:.3f} ms a "
          f"scan ({R} - {float(np.mean(iters)):.2f} mean iterations); one "
          f"masked keyframe save {save_ms:.3f} ms as a graph, {masked_ms:.3f} "
          f"ms a scan on the scans that are no keyframe (the mapping step "
          f"captured alone on the final state: at {R} against "
          f"{math.ceil(float(np.mean(iters)))} passes; gate forced down, "
          f"with and without the save)", flush=True)
    mark("pass and save costs")
    # the profiler may drop up to 5 % of its device records late in a long
    # process (as `device_ms` allows); the count itself must be exact
    if counted != R * n or not 0.95 * counted <= fused <= counted:
        fail(f"{label}: {counted} fused_corr launches counted over the "
             f"chunk and {fused} in the profile, {R * n} by design")
    return launches, fused, err


def carried_pipeline_replay(run, staged, fixture, hd, scans):
    """Phase 19 (a) again on the captured graphs, each scan starting from
    the JAX front-end's state before it (recorded in the fixture): the
    mapping path alone against the reference, without the reference's
    float32 error in its first covariance update.  The GN iterations as
    `iteration_parting` holds them (within CARRIED_MAX_ITER_DIFF a scan,
    sums no further apart than the scans that differ), the degenerate flags
    equal, the poses within the mapping limits (0.02 m, 0.1 deg: each
    parting moves its scan's pose by up to a threshold step, and that
    carries into the map and later guesses; phase 16's carried 1e-3 m is
    too tight here, the card parts by about 2.3e-3 m).
    The same carried run through the eager `HostDrivenReplay` `hd` must
    give the graphs' iterations and poses; its GN traces are what
    `iteration_parting` prints beside the reference's at each scan that
    differs (a graph cannot call back to the host)."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.pipeline import replay

    label = "pipeline replay, carried IMU state"
    prog = run.program
    ref_fes = [fixture_imu_state(fixture, i, run.device)
               for i in range(len(fixture["poses"]))]

    def substituting(map_scan):
        def wrapped(batch, i):
            replay._copy_into(prog.fes, ref_fes[i])
            return map_scan(batch, i)
        return wrapped

    restore = sync_free(run) + [run_wrapped(prog, "map_scan", substituting)]
    try:
        _, _, outs = no_sync(run, *run.init(), staged)
        torch.cuda.synchronize()
    finally:
        for undo in reversed(restore):
            undo()

    def reference_state(fn):
        """Calls of `fn(fes, ...)` take the reference's state of scan k on
        their k-th call."""
        calls = iter(range(len(scans)))

        def wrapped(fes, *a, **k):
            return fn(ref_fes[next(calls)], *a, **k)
        return wrapped

    traces = []
    restore = [run_wrapped(hd, "_prep_predict", reference_state),
               run_wrapped(hd, "correct", reference_state)]
    restore += gn_tracing(hd, traces)
    try:
        _, _, eager = hd.run(*hd.init(), scans)
    finally:
        for undo in reversed(restore):
            undo()
    poses = outs.poses.cpu().numpy()
    iters = outs.iters.cpu().numpy()
    degen = outs.degenerate.cpu().numpy()
    d_eager = float(np.abs(poses - eager.poses.cpu().numpy()).max())
    dev_t = float(np.abs(poses[:, 3:] - fixture["poses"][:, 3:]).max())
    dev_r = float(np.abs(poses[:, :3] - fixture["poses"][:, :3]).max())
    print(f"{label}: max deviation {dev_t:.3e} m, {math.degrees(dev_r):.3e} "
          f"deg; degenerate flags differ at "
          f"{np.nonzero(degen != fixture['degenerate'])[0].tolist()}; the "
          f"eager replay carried the same way within {d_eager:.3e} of the "
          f"graphs", flush=True)
    failures = []
    if not np.array_equal(iters, eager.iters.cpu().numpy()) or d_eager > 1e-5:
        failures.append("the eager carried replay parts from the graphs'")
    failures += iteration_parting(label, iters, traces, fixture, hd.cfg)
    parting_summary(label, iters, traces, fixture, hd.cfg)
    if (degen != fixture["degenerate"]).any():
        failures.append("degenerate flags differ")
    if dev_t > MAX_DEV_M or dev_r > MAX_DEV_RAD:
        failures.append(f"deviation {dev_t} m / {dev_r} rad")
    if failures:
        fail(f"{label}: " + "; ".join(failures))


def parting_summary(label, iters, traces, fixture, cfg):
    """At each scan whose GN iterations differ from the reference's, both
    packages' step at the last pass of the shorter run, over the
    convergence thresholds (`gn_steps`): the shorter run stopped there
    under 1.0, the longer went on at 1.0 or more.  Prints them and how
    many lie within a factor 2 of the threshold on both sides."""
    import numpy as np

    rcfg = cfg.registration
    rows = []
    for k in np.nonzero(iters != fixture["registration_iters"])[0]:
        n_j, n_p = int(fixture["registration_iters"][k]), int(iters[k])
        m = min(n_j, n_p)
        if m == 0:
            continue
        ref = gn_steps(fixture["gn_poses"][k, :n_j + 1], rcfg)
        got = gn_steps(np.stack([p.cpu().numpy() for p, _ in traces[k][0]]),
                       rcfg)
        rows.append((int(k), ref[m - 1], got[m - 1]))
    near = sum(0.5 <= a <= 2.0 and 0.5 <= b <= 2.0 for _, a, b in rows)
    print(f"{label}: at the last pass of the shorter run, steps over the "
          f"threshold (scan, JAX, port): {rows}; {near} of {len(rows)} "
          f"partings with both within a factor 2 of the threshold",
          flush=True)


def loop_replay_phase():
    """Phase 19 (b): the loop mission's circle (`loop_mission_config()`,
    130 scans, no GPS in a replay) through `ChunkedReplay(loop_every=10)`,
    the detector and the full correction after each chunk, held to
    fixtures/loop_replay_jax.npz.  Returns the kernel launches of the run
    (the graphs' and the loop verifications')."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.pipeline import replay
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    label = "loop replay"
    mark = step_clock(label)
    fixture = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                                   "loop_replay_jax.npz"))
    cfg = sm.loop_mission_config()
    seq, batch = sm.loop_replay_inputs()
    digest = sm.batch_sha256(batch)
    if digest != str(fixture["batch_sha256"]):
        fail(f"{label}: the inputs differ from those the reference replayed "
             f"({digest}, reference {fixture['batch_sha256']})")
    cr = replay.ChunkedReplay(cfg, loop_every=sm.LOOP_EVERY)
    chunks = cr.split(batch)
    state, fes = cr.init()
    mark("inputs made and staged")
    cr.capture(state, fes, chunks[0])
    mark("capture")
    corrected, loops, cycles = [], [], []
    full_correct, detector = cr.full_correct, cr.detector

    def noting_detector(st):
        st, aux = detector(st)
        cycles.append(aux)
        return st, aux

    def noting_correct(st):
        if bool(st.needs_full_solve):
            corrected.append(len(cycles) * sm.LOOP_EVERY - 1)
        st = full_correct(st)
        loops.append(int(st.loop_count))
        return st

    cr.detector, cr.full_correct = noting_detector, noting_correct
    restore = sync_free(cr)
    try:
        state, fes = cr.init()
        t0 = time.perf_counter()
        zero_launches()
        state, fes, outs = no_sync(cr.run, state, fes, chunks)
        launches = fc.KERNEL_LAUNCHES
        gn_launches("loop_replay", launches, graph_scans=outs.poses.shape[0])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        for undo in reversed(restore):
            undo()
    mark("chunked replay")
    poses = outs.poses.cpu().numpy()
    iters = outs.iters.cpu().numpy()
    print(f"{label} ({SMI}): {len(poses)} scans in {elapsed:.3f} s, capture "
          f"{cr.capture_seconds:.3f} s; loops after each chunk {loops} (JAX "
          f"{fixture['loop_count'].tolist()}); full corrections at scans "
          f"{corrected} (JAX {fixture['full_correction_scans'].tolist()}); "
          f"GN iterations {int(iters.sum())} (JAX "
          f"{int(fixture['registration_iters'].sum())})", flush=True)
    verify, failures = check_replay_launches(
        label, launches, len(poses), cfg.registration.max_iterations, cycles)
    if loops != fixture["loop_count"].tolist():
        failures.append(f"{label}: loop counts {loops}")
    if corrected != fixture["full_correction_scans"].tolist() or not corrected:
        failures.append(f"{label}: full corrections at {corrected}")
    if not np.isfinite(poses).all():
        failures.append(f"{label}: non-finite poses")
    first = int(fixture["full_correction_scans"][0]) if len(
        fixture["full_correction_scans"]) else len(poses) - 1
    spans = [("up to the first correction", slice(0, first + 1),
              LOOP_GPS_MAX_DEV_M, LOOP_GPS_MAX_DEV_RAD)]
    if first + 1 < len(poses):
        spans.append(("after it", slice(first + 1, None), LOOP_MAX_DEV_M,
                      LOOP_MAX_DEV_RAD))
    failures += deviation_spans(label, poses, fixture["poses"], spans)
    if not verify:
        failures.append(f"{label}: no loop verification launched the kernel")
    if failures:
        fail("; ".join(failures))
    return launches


def resident_replay_phase():
    """Phase 19: (a) `pipeline_replay_phase`, (b) `loop_replay_phase`."""
    a, graph_launches, err = pipeline_replay_phase()
    b = loop_replay_phase()
    return a, graph_launches, b, err


# phase 20 (a): (name, grid_halo, bucket cap, scan sorted by cell), each
# against the kernel phase's scan and map
LAYOUT_KERNELS = (("xy", "xy", 72, False), ("full", "full", 128, False),
                  ("none", "none", 24, False), ("sorted", "z", 24, True))
LAYOUT_REPLAY_SCANS = 20       # phase 20 (c)
# phase 20 (b): the scans of the "xy" and "full" missions whose first
# launch is probed, from the sparse map of the first keyframes on
LAYOUT_PROBE_SCANS = (1, 2, 3, 5, 10, 20, 39)
LAYOUT_MAX_ATE_REL = 0.10      # phase 20 (b): ATE within 10 % of the reference's


def layout_kernel_phase(dev):
    """Phase 20 (a): the kernel at each instantiation phase 2 does not run
    (3 bucket ids a point at "xy", 1 at "full", 27 at "none") and at "z"
    on the cell-sorted scan, on phase 2's scan and map, with the grid's
    counts as the main path passes them: held to the plain version
    (`bag_kernel_check`: the float64 arbiter on entries that cancel),
    repeated launches bit-identical, at 1 and 3 ids bit-equal to the launch
    on whole rows (`counts=None`), device ms warm and with a cold L2 (and
    on whole rows), the launch floor warm and cold, per-call ms, the plain
    version's device ms, the bound from the filled slots beside the
    whole-row bound, and the slots filled against rows x C.  Returns the
    JSON line's `layouts` object."""
    import torch

    from lio_slam_tpu_torch.ops import _build
    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.ops import registration as reg
    from lio_slam_tpu_torch.ops import voxel_grid as vg
    from lio_slam_tpu_torch.utils import se3

    kw = dict(nn_radius=1.0, plane_dist_thresh=0.2, robust_weight_floor=0.1)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    layouts = {}
    for name, halo, cap, srt in LAYOUT_KERNELS:
        grid, scan0, mask0, pose, _ = kernel_scene(dev, halo, cap)
        scan, mask = (reg._cell_sorted(scan0, mask0, 1.0) if srt
                      else (scan0, mask0))
        hh = vg.bucket_ids(se3.transform_points(*se3.pose6_to_Rt(pose), scan),
                           grid.cell_size, TABLE, halo)
        label = (f"layout {name} ({halo}/{cap}, {hh.shape[0]} ids a point"
                 f"{', scan sorted by cell' if srt else ''})")
        err = bag_kernel_check(label, ((grid.table, hh, scan, mask, pose),
                                       dict(kw, counts=grid.counts)))
        out = fc.fused_normal_equations(grid, scan, mask, pose, halo=halo, **kw)
        again = fc.fused_normal_equations(grid, scan, mask, pose, halo=halo,
                                          **kw)
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            fail(f"{label}: repeated launches are not bit-identical")
        whole = fc.fused_ne_from_bucket_ids(grid.table, hh, scan, mask, pose,
                                            **kw)
        if not all(torch.equal(a, b) for a, b in zip(out, whole)):
            fail(f"{label}: the launch with the grid's counts is not "
                 "bit-equal to the launch on whole rows")
        if int(out[2]) < N_SCAN // 4:
            fail(f"{label}: only {int(out[2])} inliers on a scan drawn from "
                 "the map")
        kernel = lambda: fc.fused_ne_from_bucket_ids(grid.table, hh, scan,
                                                     mask, pose, **kw,
                                                     counts=grid.counts)
        whole_rows = lambda: fc.fused_ne_from_bucket_ids(grid.table, hh, scan,
                                                         mask, pose, **kw)
        plain = lambda: fc.fused_ne_from_bucket_ids_ref(grid.table, hh, scan,
                                                        mask, pose, **kw)
        # in turns; the kernel's device time is its one kernel's mean
        # duration (`named_kernel_ms`), which a record the tracer drops
        # does not bias (at 27 ids it drops 3 of 20 in every pass)
        on_device = [device_ms(plain),
                     named_kernel_ms(kernel, "fused_corr_groups"),
                     named_kernel_ms(kernel, "fused_corr_groups"),
                     device_ms(plain)]
        per_call = call_ms(kernel)
        cold = named_kernel_ms(kernel, "fused_corr_groups",
                               between=lambda: flush.fill_(1.0))
        # at 9 and 27 ids the kernel does not read counts: the same launch
        whole_ms = (named_kernel_ms(whole_rows, "fused_corr_groups")
                    if hh.shape[0] <= 3 else None)
        floor = floor_ms(grid.table, hh, scan, mask, pose, **kw)
        floor_cold = floor_ms(grid.table, hh, scan, mask, pose, **kw,
                              between=lambda: flush.fill_(1.0))
        bound = kernel_bound(grid.table, hh, scan, mask, grid.counts)
        ms = min(on_device[1:3])
        warps = _build.load_fused_corr().lio_fused_corr_block_warps(
            int(hh.shape[0]), cap)
        print(f"{label} ({SMI}): {warps} warps a block; "
              f"{int(grid.counts.sum())} slots filled in the grid; "
              f"inliers {int(out[2])}; device ms per call (torch.profiler; "
              f"the kernel's own launch) plain, kernel, kernel, plain = "
              f"{', '.join(f'{x:.4f}' for x in on_device)}; cold L2 "
              f"{cold:.4f}; "
              + (f"on whole rows (counts=None) {whole_ms:.4f}; "
                 if whole_ms is not None else "")
              + f"launch floor {floor:.4f}, cold L2 {floor_cold:.4f}; per call "
              f"as the caller sees it {per_call:.4f}; slots filled "
              f"{bound['filled']} of rows x C = {bound['slots']} "
              f"({bound['rows']} distinct bucket rows read, "
              f"{bound['filled'] / bound['slots']:.4f} filled; a point's "
              f"rows {bound['scanned'] / bound['point_slots']:.4f} filled); bound "
              f"{bound['ms']:.5f} ms by {bound['by']} ({bound['bytes']} bytes, "
              f"{bound['flop']} FLOP; whole rows {bound['whole_ms']:.5f}), "
              f"time over bound {ms / bound['ms']:.2f} (whole-row bound "
              f"{ms / bound['whole_ms']:.2f}), over the floor "
              f"{ms - floor:.4f} ms", flush=True)
        layouts[name] = {"halo": halo, "offsets": int(hh.shape[0]), "cap": cap,
                         "warps": warps, "sorted_scan": srt,
                         "ms": ms, "plain_ms": min(on_device[0], on_device[3]),
                         "cold_ms": cold, "whole_rows_ms": whole_ms,
                         "floor_ms": floor, "floor_cold_ms": floor_cold,
                         "call_ms": per_call, "bound_ms": bound["ms"],
                         "bound_by": bound["by"],
                         "bound_whole_rows_ms": bound["whole_ms"],
                         "slots_filled": bound["filled"],
                         "slots_read": bound["slots"], "max_abs_err": err}
    return layouts


def layout_mission(dev, cfg, scans, imus, carried_from=None, probe=(),
                   path=None):
    """(results, kernel launches, steady scans/s over scans 5-39, keyframes,
    probed) of `Runner(cfg)` on the card over the scans; with
    `carried_from` each scan starts from that fixture's IMU front-end
    state.  `probed` maps each scan of `probe` to the arguments of its
    first kernel launch, cloned."""
    import torch

    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.pipeline.runner import Runner

    runner = Runner(cfg, device=dev)
    results, stamps, probed, at = [], [], {}, [None]

    def probing(kernel):
        def wrapped(*a, **k):
            if at[0] in probe and at[0] not in probed:
                probed[at[0]] = (
                    *(x.clone() if isinstance(x, torch.Tensor) else x
                      for x in a),
                    {n: v.clone() if isinstance(v, torch.Tensor) else v
                     for n, v in k.items()})
            return kernel(*a, **k)
        return wrapped

    undo = run_wrapped(fc, "fused_ne_from_bucket_ids", probing)
    try:
        zero_launches()
        for i in range(len(scans)):
            at[0] = i
            if carried_from is not None:
                runner.imu_state = fixture_imu_state(carried_from, i, dev)
            results.append(runner.process_scan(scans[i], imu=imus[i]))
            stamps.append(time.perf_counter())
        torch.cuda.synchronize()
        launches = fc.KERNEL_LAUNCHES
        if path is not None:
            gn_launches(path, launches,
                        sum(r.registration_iters > 0 for r in results))
    finally:
        undo()
    return (results, launches, (len(scans) - 5) / (stamps[-1] - stamps[4]),
            int(runner.state.store.count), probed)


def launch_graph_ms(launch, per_graph=20, runs=5):
    """Device ms a launch of `launch` (no arguments, raw launches on the
    current stream): `per_graph` launches captured back to back as one CUDA
    graph, CUDA events around a replay, the median of `runs` replays over
    `per_graph`.  A graph's nodes carry no host time but a gap each, the
    same for any kernel, so two launchers compare."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
        launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(per_graph):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_graph)
    times.sort()
    return times[len(times) // 2]


def prefix_probe(label, probed):
    """Phase 20 (b) at 1 and 3 ids a point: on the inputs of the first
    launch of each probed scan of a mission (the map that scan sees), a
    point's rows' filled share (`kernel_bound`: the filled slots the
    unmasked points scan over C a live row) and the kernel's device ms a
    launch with the grid's counts and on whole rows (`counts=None`), in
    turns (`launch_graph_ms`; raw launches on a scratch of their own, no
    launch of the main path, not counted), the two results bit-equal.
    Returns {scan: (filled share, ms with counts, ms on whole rows)}."""
    import torch

    from lio_slam_tpu_torch.ops import _build
    from lio_slam_tpu_torch.ops import fused_corr as fc

    lib = _build.load_fused_corr()
    out = {}
    for i, (table, hh, scan, mask, pose, kw) in sorted(probed.items()):
        counts = kw["counts"]
        bound = kernel_bound(table, hh, scan, mask, counts)
        share = bound["scanned"] / bound["point_slots"]
        scratch = torch.zeros(lib.lio_fused_corr_scratch_floats(),
                              dtype=torch.float32, device=table.device)
        words = {}

        def launcher(c):
            args = fc._kernel_args(table, hh, scan, mask, pose, kw["nn_radius"],
                                   kw["plane_dist_thresh"],
                                   kw["robust_weight_floor"], counts=c)
            res = words.setdefault(c is None, torch.empty(
                fc.OUT_WORDS, dtype=torch.float32, device=table.device))

            def launch():
                err = lib.lio_fused_corr(
                    *args, scratch.data_ptr(), scratch.numel(), res.data_ptr(),
                    torch.cuda.current_stream(table.device).cuda_stream)
                if err != 0:
                    fail(f"{label}: launch refused, cudaError_t {err}")
            return launch

        with_counts, whole = launcher(counts), launcher(None)
        t = [launch_graph_ms(with_counts), launch_graph_ms(whole),
             launch_graph_ms(whole), launch_graph_ms(with_counts)]
        if not torch.equal(words[False].view(torch.int32),
                           words[True].view(torch.int32)):
            fail(f"{label}, scan {i}: the launch with the grid's counts is "
                 "not bit-equal to the launch on whole rows")
        ms, ms_whole = min(t[0], t[3]), min(t[1], t[2])
        print(f"{label}, scan {i} ({SMI}): {int(mask.sum())} points, "
              f"{bound['filled']} slots filled in the {bound['rows']} rows "
              f"read; a point's rows {share:.4f} filled ({bound['scanned']} "
              f"of {bound['point_slots']} slots); device ms a launch "
              f"(graph of 20) with counts, whole rows, whole rows, with "
              f"counts = {', '.join(f'{x:.5f}' for x in t)}; with counts / "
              f"whole rows {ms / ms_whole:.4f}", flush=True)
        out[i] = (share, ms, ms_whole)
    return out


def layout_missions_phase(dev, default_rate):
    """Phase 20 (b): the 40-scan smoke mission through `Runner(device=
    "cuda")` under each of `synthetic_mission.LAYOUT_MISSIONS`, held to
    fixtures/layout_missions_jax.npz (the JAX Runner of the same config):
    launches equal to the GN iterations, the deviation within the mapping
    limits, the keyframe count, the ATE within 10 % of the reference's;
    then with the reference's IMU state carried in, GN iterations within 1
    a scan, and at "xy" and "full" `prefix_probe` on the first launch of
    each of LAYOUT_PROBE_SCANS.  Each rate is printed beside
    `default_rate`, phase 3's.
    Returns each mission's launches."""
    import numpy as np

    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    fixture = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                                   "layout_missions_jax.npz"))
    seq = synthetic.make_sequence(n_scans=sm.SMOKE_SCANS, n_points=sm.SMOKE_POINTS,
                                  seed=sm.SMOKE_SEED, speed=sm.SMOKE_SPEED)
    truth = sm.relative_truth(seq)
    launches, failures = {}, []
    for name, halo, cap, srt, ds in sm.LAYOUT_MISSIONS:
        label = f"layout mission {name}"
        ref = {k[len(name) + 1:]: fixture[k] for k in fixture.files
               if k.startswith(name + "_")}
        cfg = sm.layout_mission_config(halo, cap, srt, ds)
        scans, imus = sm.synthetic_inputs(seq, cfg)
        results, n_launch, rate, kf, _ = layout_mission(
            dev, cfg, scans, imus, path=f"layout_{name}")
        launches[name] = n_launch
        poses = np.stack([r.pose for r in results])
        iters = np.array([r.registration_iters for r in results])
        ate = synthetic.ate_rmse(poses, truth)
        ate_ref = float(ref["ate_rmse_m"])
        print(f"{label} ({halo}/{cap}, sort_scan_by_cell={srt}, "
              f"scan_downsample={ds!r}; {SMI}): {rate:.3f} scans/s over scans "
              f"5-39 (phase 3's default mission {default_rate:.3f}); "
              f"launches {n_launch}, GN "
              f"iterations {int(iters.sum())} (JAX "
              f"{int(ref['registration_iters'].sum())}); keyframes {kf} (JAX "
              f"{int(ref['keyframes'])}); ATE {ate:.5f} m (JAX {ate_ref:.5f} m)",
              flush=True)
        failures += deviation_spans(label, poses, ref["poses"], (
            ("free-running", slice(None), MAX_DEV_M, MAX_DEV_RAD),))
        if n_launch != int(iters.sum()) or n_launch == 0:
            failures.append(f"{label}: {n_launch} launches, {int(iters.sum())} "
                            "GN iterations")
        if kf != int(ref["keyframes"]):
            failures.append(f"{label}: {kf} keyframes, JAX {int(ref['keyframes'])}")
        if not abs(ate - ate_ref) <= LAYOUT_MAX_ATE_REL * ate_ref:
            failures.append(f"{label}: ATE {ate} m against the reference's "
                            f"{ate_ref} m")
        carried, _, _, _, probed = layout_mission(
            dev, cfg, scans, imus, carried_from=ref,
            probe=LAYOUT_PROBE_SCANS if halo in ("xy", "full") else ())
        if probed:
            prefix_probe(label, probed)
        c_poses = np.stack([r.pose for r in carried])
        d_it = np.array([r.registration_iters for r in carried]) \
            - ref["registration_iters"]
        print(f"{label}, carried IMU state: max deviation "
              f"{np.abs(c_poses[:, 3:] - ref['poses'][:, 3:]).max():.3e} m, "
              f"{math.degrees(np.abs(c_poses[:, :3] - ref['poses'][:, :3]).max()):.3e} "
              f"deg; GN iterations differ at scans {np.nonzero(d_it)[0].tolist()} "
              f"(sums {int(d_it.sum()):+d})", flush=True)
        if np.abs(d_it).max() > CARRIED_MAX_ITER_DIFF:
            failures.append(f"{label}, carried: GN iterations differ by "
                            f"{np.abs(d_it).max()} on a scan")
    if failures:
        fail("; ".join(failures))
    return launches


def layout_replay_phase():
    """Phase 20 (c): `layout_replay` under the cell-sorted, hash-downsampled
    mission's config (`LAYOUT_MISSIONS`' last), then under "xy"/72 and
    "full"/128, whose captured launches read the state grid's own counts
    (the filled prefixes the in-graph insert leaves).  Returns each
    replay's launches."""
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    missions = {m[0]: m for m in sm.LAYOUT_MISSIONS}
    return {"replay": layout_replay(
                "layout replay (sorted scan, hash downsample)",
                sm.LAYOUT_MISSIONS[-1]),
            **{f"replay_{name}": layout_replay(
                f"layout replay ({name}/{missions[name][2]})", missions[name])
               for name in ("xy", "full")}}


def layout_replay(label, mission):
    """`make_pipeline_replay` over the first LAYOUT_REPLAY_SCANS scans of
    phase 19's inputs under a `LAYOUT_MISSIONS` config: poses, GN
    iterations and degenerate flags bit-equal to `HostDrivenReplay`'s in
    the same process, no synchronization under
    `set_sync_debug_mode("error")`, the launches counted over the graphs'
    run 30 a scan plus the loop verifications'.  Returns those launches."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.pipeline import replay
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    _, halo, cap, srt, ds = mission
    cfg = sm.layout_mission_config(halo, cap, srt, ds)
    _, batch = sm.pipeline_replay_inputs(n_scans=LAYOUT_REPLAY_SCANS)
    hd = replay.HostDrivenReplay(cfg, loop_every=sm.LOOP_EVERY)
    _, _, eager = hd.run(*hd.init(), hd.split(batch))
    run = replay.make_pipeline_replay(cfg, loop_every=sm.LOOP_EVERY)
    staged = run.stage(batch)
    run.capture(*run.init(), staged)
    cycles = []
    restore = sync_free(run) + [watched_detector(run, cycles)]
    try:
        zero_launches()
        _, _, outs = no_sync(run, *run.init(), staged)
        launches = fc.KERNEL_LAUNCHES
        gn_launches(f"layout_replay_{mission[0]}", launches,
                    graph_scans=outs.poses.shape[0])
        torch.cuda.synchronize()
    finally:
        for undo in reversed(restore):
            undo()
    failures = check_replay_launches(label, launches, LAYOUT_REPLAY_SCANS,
                                     cfg.registration.max_iterations, cycles)[1]
    same = {k: torch.equal(getattr(outs, k), getattr(eager, k))
            for k in ("poses", "iters", "degenerate")}
    d = float((outs.poses - eager.poses).abs().max())
    print(f"{label}: {LAYOUT_REPLAY_SCANS} scans as CUDA graphs (capture "
          f"{run.capture_seconds:.3f} s) against HostDrivenReplay in the same "
          f"process: bit-equal {same} (poses within {d:.3e}); GN iterations "
          f"{int(outs.iters.sum())}; no synchronization under 'error' mode",
          flush=True)
    if not all(same.values()):
        failures.append(f"{label}: not bit-equal to the host-driven replay "
                        f"{same}")
    if not np.isfinite(outs.poses.cpu().numpy()).all():
        failures.append(f"{label}: non-finite poses")
    if failures:
        fail("; ".join(failures))
    return launches


def layout_paths_phase(dev, default_rate):
    """Phase 20 (b) and (c); (a) runs beside phase 2, where the tracer
    still keeps every record (after phase 19 it drops most of them)."""
    launches = layout_missions_phase(dev, default_rate)
    launches.update(layout_replay_phase())
    return launches


# ---- phase 21: the resident replays at the rebuild-mode map and corner configs ----

REBUILD_PROFILED = (20, 25)     # phase 21 (a): the profiled chunk's scans


def rebuild_replay_phase():
    """Phase 21 (a): the first REBUILD_REPLAY_SCANS scans of phase 19's
    inputs at `rebuild_replay_config()` (the rebuild-mode map, a local map
    of 131072 points assembled and its grid built each scan) through
    `make_pipeline_replay(loop_every=10)` as CUDA graphs and through
    `HostDrivenReplay` in the same process: bit-equal, no synchronization
    inside the replay, launches 30 a scan plus the loop verifications';
    against the JAX monolith (`pipeline_replay_jax.npz`, keys `rebuild_`)
    within the mapping limits with equal degenerate flags, and with the
    reference's IMU state carried in, GN iterations within 1 a scan; the
    kernel on the arguments of one launch inside graph (a), on the grid
    built there, against its plain version.  Returns (the launches of the
    timed run, the kernel check's largest difference)."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.pipeline import replay
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    label = "rebuild replay"
    mark = step_clock(label)
    fixture = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                                   "pipeline_replay_jax.npz"))
    ref = {k[len("rebuild_"):]: fixture[k] for k in fixture.files
           if k.startswith("rebuild_")}
    cfg = sm.rebuild_replay_config()
    n = sm.REBUILD_REPLAY_SCANS
    seq, batch = sm.pipeline_replay_inputs(n_scans=n)
    if sm.batch_sha256(batch) != str(ref["batch_sha256"]):
        fail(f"{label}: the inputs differ from those the reference replayed")

    hd = replay.HostDrivenReplay(cfg, loop_every=sm.LOOP_EVERY)
    eager, hd_rate = host_driven_run(hd, hd.split(batch))
    mark("host-driven replay")

    run = replay.make_pipeline_replay(cfg, loop_every=sm.LOOP_EVERY)
    staged = run.stage(batch)
    R = cfg.registration.max_iterations
    tapped = []
    undo = run_wrapped(fc, "fused_ne_from_bucket_ids",
                       graph_tap(2 * R + PIPELINE_TAP_PASS, tapped))
    try:
        run.capture(*run.init(), staged)
    finally:
        undo()
    mark("capture")
    events, undo_ev = scan_events(run.program)
    cycles = []
    restore = sync_free(run) + [undo_ev, watched_detector(run, cycles)]
    try:
        zero_launches()
        state, _, outs = no_sync(run, *run.init(), staged)
        launches = fc.KERNEL_LAUNCHES
        gn_launches("rebuild_replay", launches,
                    graph_scans=outs.poses.shape[0])
        torch.cuda.synchronize()
    finally:
        for undo in reversed(restore):
            undo()
    graph_rate = steady_rate(events, 4, n - 1)
    mark("graph replay")

    _, failures = check_replay_launches(label, launches, n, R, cycles)
    same = {k: torch.equal(getattr(outs, k), getattr(eager, k))
            for k in ("poses", "iters", "degenerate")}
    poses = outs.poses.cpu().numpy()
    iters = outs.iters.cpu().numpy()
    degen = outs.degenerate.cpu().numpy()
    ate = synthetic.ate_rmse(poses, sm.relative_truth(seq))
    print(f"{label} ({SMI}): {n} scans at max_map_points "
          f"{cfg.static.max_map_points}; capture {run.capture_seconds:.3f} s "
          f"(warm-up included); scans 5-{n - 1} {graph_rate:.3f} scans/s as "
          f"CUDA graphs, {hd_rate:.3f} scans/s host-driven (the same "
          f"process); bit-equal to the host-driven replay {same}; GN "
          f"iterations {int(iters.sum())} (JAX "
          f"{int(ref['registration_iters'].sum())}); keyframes "
          f"{int(state.store.count)} (JAX {int(ref['keyframes'])}); ATE "
          f"{ate:.5f} m (JAX {float(ref['ate_rmse_m']):.5f} m); fused_corr "
          f"nodes of graphs (a), (b): {run.program.graph_launches}",
          flush=True)
    if not all(same.values()):
        failures.append(f"{label}: not bit-equal to the host-driven replay "
                        f"{same}")
    if not np.isfinite(poses).all():
        failures.append(f"{label}: non-finite poses")
    if (degen != ref["degenerate"]).any():
        failures.append(f"{label}: degenerate flags differ from JAX's")
    if int(state.store.count) != int(ref["keyframes"]):
        failures.append(f"{label}: {int(state.store.count)} keyframes")
    failures += deviation_spans(label, poses, ref["poses"], (
        ("free-running", slice(None), MAX_DEV_M, MAX_DEV_RAD),))
    if not tapped:
        failures.append(f"{label}: no launch tapped in the capture")

    # with the reference's IMU state carried into each scan
    prog = run.program
    ref_fes = [fixture_imu_state(ref, i, run.device) for i in range(n)]

    def substituting(map_scan):
        def wrapped(b, i):
            replay._copy_into(prog.fes, ref_fes[i])
            return map_scan(b, i)
        return wrapped

    restore = sync_free(run) + [run_wrapped(prog, "map_scan", substituting)]
    try:
        _, _, carried = no_sync(run, *run.init(), staged)
        torch.cuda.synchronize()
    finally:
        for undo in reversed(restore):
            undo()
    c_iters = carried.iters.cpu().numpy()
    d_it = c_iters.astype(int) - ref["registration_iters"]
    c_poses = carried.poses.cpu().numpy()
    print(f"{label}, carried IMU state: GN iterations differ from JAX's at "
          f"scans {np.nonzero(d_it)[0].tolist()} (by up to "
          f"{np.abs(d_it).max()}); free-running at "
          f"{np.nonzero(iters != ref['registration_iters'])[0].tolist()}",
          flush=True)
    if np.abs(d_it).max() > CARRIED_MAX_ITER_DIFF:
        failures.append(f"{label}, carried: GN iterations differ by "
                        f"{np.abs(d_it).max()} on a scan")
    failures += deviation_spans(f"{label}, carried", c_poses, ref["poses"], (
        ("carried", slice(None), MAX_DEV_M, MAX_DEV_RAD),))
    if failures:
        fail("; ".join(failures))
    mark("carried graph replay")

    args, kw, graph_out = tapped[0]
    err = bag_kernel_check(f"{label} graph (a), pass {PIPELINE_TAP_PASS} of "
                           "the last scan (the grid built in the graph)",
                           (args, kw))
    check_ne(f"{label} graph (a)'s own results of that launch", graph_out,
             fc.fused_ne_from_bucket_ids_ref(*args, **kw))
    lo, hi = REBUILD_PROFILED
    busy, wall_ms, fused, _, counted = profiled_chunk(run, staged, lo, hi)
    k = hi - lo
    print(f"{label} profiled chunk, scans {lo}-{hi - 1} ({SMI}): device "
          f"{busy / k:.3f} ms a scan, busy {busy:.3f} ms of {wall_ms:.3f} ms "
          f"wall (idle share {1.0 - busy / wall_ms:.3f}); fused_corr "
          f"launches {fused} in the profile, {counted} counted ({R} a scan "
          f"by design); unprofiled, the graphs ran scans 5-{n - 1} at "
          f"{1e3 / graph_rate:.3f} ms a scan", flush=True)
    if counted != R * k or not 0.95 * counted <= fused <= counted:
        fail(f"{label}: {counted} fused_corr launches counted over the "
             f"chunk and {fused} in the profile, {R * k} by design")
    mark("kernel check and profiled chunk")
    return launches, err


def corner_replay_phase():
    """Phase 21 (b): the first CORNER_REPLAY_SCANS scans of phase 19's
    inputs through `make_pipeline_replay(loop_every=10)` as CUDA graphs
    under the corner config (`corner_mission_config()`: the LOAM corner
    term on; a replay feeds no corner cloud, so the step takes the surface
    path, as the JAX step does) and under `bench_config()`: the outputs bit
    for bit, no synchronization, launches 30 a scan each.  Returns the
    corner run's launches."""
    import torch

    from lio_slam_tpu_torch.ops import fused_corr as fc
    from lio_slam_tpu_torch.pipeline import replay
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    label = "corner replay"
    n = sm.CORNER_REPLAY_SCANS
    _, batch = sm.pipeline_replay_inputs(n_scans=n)
    outs, launches, failures = {}, {}, []
    for name, cfg in (("surface", sm.bench_config()),
                      ("corner", sm.corner_mission_config())):
        run = replay.make_pipeline_replay(cfg, loop_every=sm.LOOP_EVERY)
        staged = run.stage(batch)
        run.capture(*run.init(), staged)
        cycles = []
        restore = sync_free(run) + [watched_detector(run, cycles)]
        try:
            zero_launches()
            _, _, outs[name] = no_sync(run, *run.init(), staged)
            launches[name] = fc.KERNEL_LAUNCHES
            gn_launches(f"corner_replay_{name}", launches[name],
                        graph_scans=outs[name].poses.shape[0])
            torch.cuda.synchronize()
        finally:
            for undo in reversed(restore):
                undo()
        failures += check_replay_launches(
            f"{label} ({name} config)", launches[name], n,
            cfg.registration.max_iterations, cycles)[1]
    same = {k: torch.equal(getattr(outs["corner"], k),
                           getattr(outs["surface"], k))
            for k in ("poses", "iters", "degenerate", "fused_last")}
    print(f"{label} ({SMI}): {n} scans as CUDA graphs under the corner "
          f"config and the surface config: bit-equal {same}; GN iterations "
          f"{int(outs['corner'].iters.sum())}", flush=True)
    if not all(same.values()):
        failures.append(f"{label}: the corner config parts from the surface "
                        f"config {same}")
    if failures:
        fail("; ".join(failures))
    return launches["corner"]


def resident_modes_phase():
    """Phase 21: (a) `rebuild_replay_phase`, (b) `corner_replay_phase`."""
    rebuilt, err = rebuild_replay_phase()
    return rebuilt, corner_replay_phase(), err


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile-dir", default=None,
                    help="also write the torch.profiler table of scans 10-19 "
                         "and the loop mission's per-scan results here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from lio_slam_tpu_torch.ops import _build

    global SMI
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    SMI = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
           else f"nvidia-smi: {smi.stderr.strip()}")
    print(SMI, flush=True)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} on {name}",
          flush=True)

    # both libraries build at once: nvcc the kernel, g++ the host runtime
    # of the bag phases (a runtime that does not build fails the run)
    from concurrent.futures import ThreadPoolExecutor

    from lio_slam_tpu_torch.io import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        host = pool.submit(lambda: (native.load(), time.perf_counter() - t0))
        _build.load_fused_corr()
        kernel_s = time.perf_counter() - t0
        host_s = host.result()[1]
    built = ("an existing build" if _build.BUILD_SECONDS is None
             else f"nvcc {_build.BUILD_SECONDS:.2f} s")
    print(f"kernel library ready in {kernel_s:.2f} s ({built}); host runtime "
          f"(g++, io/csrc/liorf_runtime.cpp) ready in {host_s:.2f} s, built "
          "alongside", flush=True)
    for line in _build.BUILD_LOG.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    def phase(label, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"{label}: {time.perf_counter() - t0:.1f} s wall", flush=True)
        return out

    warm_profiler(dev)
    k = phase("phase 2 (kernel)", kernel_phase, dev)
    layouts = phase("phase 20 (a) (the kernel at every gather layout)",
                    layout_kernel_phase, dev)
    gk = phase("phase 22 (the GN step's kernel)", gn_small_phase, dev)
    wk = phase("phase 23 (the window system's kernel)", window_system_phase,
               dev)
    launches, default_rate = phase("phases 3-5 (mission, carried, profiled)",
                                   mission_phase, dev, args.profile_dir)
    loop_map, loop_ver, loop_err = phase("phases 6-8 (loop mission, kernel "
                                         "check, solvers)", loop_mission_phase,
                                         args.profile_dir)
    arch, arch_err = phase("phases 9-10 (archive mission, products)",
                           archive_mission_phase, args.profile_dir)
    resumed = phase("phase 11 (resume)", resume_phase, dev)
    bag_map, bag_ver, bag_err = phase("phase 12 (bag mission)", bag_mission_phase)
    hostile, hostile_err = phase("phase 13 (hostile bag)", hostile_bag_phase)
    corner, corner_err = phase("phase 14 (corner mission, incremental map)",
                               corner_mission_phase, "incremental")
    rebuilt, rebuild_err = phase("phase 15 (corner mission, rebuild-mode map)",
                                 corner_mission_phase, "rebuild")
    hard_map, hard_ver, hard_err = phase("phase 16 (hard-tier replay)",
                                         hard_replay_phase)
    deskewed = phase("phase 17 (deskew mission)", deskew_phase)
    phase("preintegration on the card", preintegration_phase, dev)
    phase("phase 18 (sharded mission)", sharded_phase)
    pipe, pipe_graph, loop_replay, pipe_err = phase(
        "phase 19 (device-resident replay programs)", resident_replay_phase)
    layout_launches = phase("phase 20 (b)-(c) (gather-layout missions, "
                            "graph replay)", layout_paths_phase, dev,
                            default_rate)
    rebuild_replay, corner_replay, rebuild_err = phase(
        "phase 21 (resident replays at the rebuild-mode map and the corner "
        "config)", resident_modes_phase)
    if WS_FAULTS:
        fail("window_system's launches are not two a keyframe save: "
             + "; ".join(WS_FAULTS))
    paths = {"mission": launches, "loop_mapping": loop_map,
             "loop_verification": loop_ver, **arch, "resume": resumed,
             "bag_mapping": bag_map, "bag_loop_verification": bag_ver,
             "hostile_bag": hostile, "corner_mapping": corner,
             "rebuild_mapping": rebuilt, "hard_replay_mapping": hard_map,
             "hard_replay_verification": hard_ver,
             "deskew_replay": deskewed, "pipeline_replay": pipe,
             "loop_replay": loop_replay,
             **{f"layout_{k}": v for k, v in layout_launches.items()},
             "rebuild_replay": rebuild_replay, "corner_replay": corner_replay}
    print(json.dumps({"kernels": [{
        "name": "fused_corr", "route": "cuda",
        "source": "lio_slam_tpu_torch/ops/csrc/fused_corr.cu",
        "replaces": "lio_slam_tpu/ops/fused_corr.py:124",
        "launches": sum(paths.values()),
        **{f"launches_{p}": v for p, v in paths.items()},
        "launches_pipeline_replay_graph_profiled": pipe_graph,
        "max_abs_err": max(k["max_abs_err"], loop_err, arch_err, bag_err,
                           hostile_err, corner_err, rebuild_err, hard_err,
                           pipe_err, rebuild_err,
                           *(v["max_abs_err"] for v in layouts.values())),
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None, "cold_ms": k["cold_ms"],
        "entry_ms": k["entry_ms"], "entry_plain_ms": k["entry_plain_ms"],
        "layouts": {"z": {"halo": "z", "offsets": 9, "cap": CAP,
                          "warps": _build.load_fused_corr(
                              ).lio_fused_corr_block_warps(9, CAP),
                          "sorted_scan": False, "ms": k["ms"],
                          "plain_ms": k["plain_ms"], "cold_ms": k["cold_ms"],
                          "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                          "bound_whole_rows_ms": k["bound_whole_rows_ms"],
                          "floor_ms": k["floor_ms"],
                          "floor_cold_ms": k["floor_cold_ms"],
                          "slots_filled": k["slots_filled"],
                          "slots_read": k["slots_read"],
                          "max_abs_err": k["max_abs_err"]}, **layouts}}, {
        "name": "gn_small", "route": "cuda",
        "source": "lio_slam_tpu_torch/ops/csrc/gn_small.cu", "replaces": None,
        "launches": sum(n for n, _ in GN_PATHS.values()),
        "eigh_launches": sum(e for _, e in GN_PATHS.values()),
        **{f"launches_{p}": n for p, (n, _) in GN_PATHS.items()},
        **{f"eigh_launches_{p}": e for p, (_, e) in GN_PATHS.items()},
        **gk, "library_ms": None}, {
        "name": "window_system", "route": "cuda",
        "source": "lio_slam_tpu_torch/ops/csrc/window_system.cu",
        "replaces": None,
        "launches": sum(n for n, _ in WS_PATHS.values()),
        "saves": sum(v for _, v in WS_PATHS.values()),
        **{f"launches_{p}": n for p, (n, _) in WS_PATHS.items()},
        **{f"saves_{p}": v for p, (_, v) in WS_PATHS.items()},
        **wk, "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
