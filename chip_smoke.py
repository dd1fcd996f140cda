#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lio_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile-dir DIR]

1. Builds the port's CUDA kernel library from the sources in this checkout
   (nvcc, sm_90a) and prints the build time and ptxas's register report.
2. Kernel phase: at the main path's shapes (an 8192-point scan against a
   65536-point map in a 32768 x 24 bucket grid, halo "z") holds the fused
   correspondence kernel to its plain PyTorch version on the card — inlier
   count exact, AtA / Atb within rtol 2e-4 / atol 2e-3, the sums within
   rtol 1e-4 — at refresh 1, with held bucket ids, on an empty map and on a
   half-masked scan, checks that repeated launches are bit-identical, and
   times kernel and plain version: device time per call from torch.profiler
   (the JSON line's ms / plain_ms) and per-call time from CUDA events.
   The kernel is also held to its first version (`lio_fused_corr_v1`, kept
   in the source as a yardstick: same inliers, sums within the same
   tolerances, since only the order of summation differs) and to the plain
   version on a scan with a few non-finite points, and timed against the
   first version in turns (v1, kernel, kernel, v1), once with a cold L2 (a
   64 MB buffer written between launches, as the first GN iteration after a
   grid insert finds it), and against its bound: the bytes this run's
   inputs and outputs hold (distinct buckets touched x row bytes, ids, scan,
   mask, pose, outputs) over 3.35 TB/s, or its operations over 67 TFLOP/s,
   whichever is larger.
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

Prints the card's name and power limit, one JSON line describing the
kernel, and last `{"ok": true, "device": {...}}`.  Exits non-zero, without
that line, if there is no CUDA device or any check fails.
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


def device_busy_ms(prof) -> float:
    """Device time (kernels and copies) recorded by a torch.profiler run;
    the device-side spans of record_function ranges are not work."""
    import torch

    return 1e-3 * sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False))


def device_ms(fn, reps=20):
    """Device time per call: the durations of every kernel and copy `fn`
    puts on the card, summed by torch.profiler over `reps` calls.  Every
    call puts the same kernels there, so a kernel seen some other number of
    times than a multiple of `reps` means the tracer dropped records: the
    pass is made again."""
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
        if rows and all(e.count % reps == 0 for e in rows):
            return 1e-3 * sum(e.self_device_time_total for e in rows) / reps
        print("device_ms: the profiler saw "
              f"{sorted(e.count for e in rows)} launches by kernel for {reps} "
              "calls; profiling again", flush=True)
    fail("the profiler lost device records in five passes")


def named_kernel_ms(fn, name_part, reps=20, between=None):
    """Device time per launch of the kernels whose name holds `name_part`,
    from torch.profiler; `between` runs before every call (not counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and name_part in e.key]
    seen = sum(e.count for e in rows)
    if not reps // 2 <= seen <= reps:      # the tracer may drop a record
        fail(f"profiler saw {seen} launches of *{name_part}*, expected {reps}")
    return 1e-3 * sum(e.self_device_time_total for e in rows) / seen


def unpack_v1(packed):
    """The first kernel's 30 packed sums as (AtA, Atb, n_inliers, sum s,
    sum s|pd2|), with the torch ops its wrapper ran on every call."""
    import torch

    iu = torch.triu_indices(6, 6, device=packed.device)
    upper = torch.zeros((6, 6), dtype=packed.dtype, device=packed.device)
    upper[iu[0], iu[1]] = packed[:21]
    AtA = upper + upper.T - torch.diag(torch.diagonal(upper))
    return (AtA, packed[21:27], packed[27].to(torch.int32), packed[28],
            packed[29])


def kernel_bound(table, hh, scan, mask):
    """The least time the card could take for one call on these inputs:
    (bound_ms, bound_by, bytes, flop).  Bytes: each bucket row that some
    unmasked point's ids name, once; ids, scan, mask and pose once; the 45
    output words once.  Operations: 8 a candidate distance, about 300 a
    plane fit, for the unmasked points."""
    import torch

    T, C, _ = table.shape
    live = hh[:, mask]
    live = live[(live >= 0) & (live < T)]
    n_rows = int(torch.unique(live).numel())
    n_bytes = (n_rows * C * 12 + hh.numel() * 4 + scan.numel() * 4
               + mask.numel() + 6 * 4 + 45 * 4)
    n_live = int(mask.sum())
    flop = n_live * (hh.shape[0] * C * 8 + 300)
    by_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flop / FP32_FLOP_PER_S
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations",
            n_bytes, flop, n_rows)


def kernel_scene(dev):
    """The main path's shapes: an 8192-point scan drawn from a 65536-point
    map in a 32768 x 24 grid, and a pose a GN step away from the truth."""
    import numpy as np
    import torch

    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.ops import voxel_grid as vg
    from lio_slam_tpu_torch.utils import se3

    rs = np.random.RandomState(0)
    world = synthetic.make_world(0, extent=60.0)
    near = world[np.linalg.norm(world[:, :2], axis=1) < 45.0]
    map_pts = near[rs.permutation(len(near))[:N_MAP]]
    sel = rs.permutation(N_MAP)[:N_SCAN]
    pose0 = np.array([0.01, -0.02, 0.3, 1.0, -0.5, 0.2], np.float32)
    R0, t0 = se3.pose6_to_Rt(torch.from_numpy(pose0))
    # body-frame scan whose world image lies on the map, plus sensor noise
    body = ((torch.from_numpy(map_pts[sel]) - t0) @ R0).numpy()
    body = (body + rs.randn(N_SCAN, 3) * 0.02).astype(np.float32)

    grid = vg.build_grid(torch.from_numpy(map_pts).to(dev),
                         torch.ones(N_MAP, dtype=torch.bool, device=dev),
                         1.0, TABLE, CAP, halo="z")
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
    v1_raw = lambda: fc.fused_ne_from_bucket_ids_v1(grid.table, hh_now, scan,
                                                    mask, pose, **kw)
    v1 = lambda: unpack_v1(v1_raw())

    # against the first version: the same five neighbours a point, so the
    # same inliers; the sums are taken in another order, so within the
    # plain-version tolerances and not bit-equal
    launches_before = fc.KERNEL_LAUNCHES
    from_v1 = v1()
    if fc.KERNEL_LAUNCHES != launches_before:
        fail("the first version's launch was counted")
    errs.append(check_ne("against-v1", kernel(), from_v1))

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
    on_device = [device_ms(plain), device_ms(v1_raw), device_ms(kernel),
                 device_ms(kernel), device_ms(v1_raw), device_ms(plain)]
    per_call = [call_ms(plain, reps=10), call_ms(v1), call_ms(kernel),
                call_ms(kernel), call_ms(v1), call_ms(plain, reps=10)]
    # the kernel alone (without the wrapper's allocation), warm and with a
    # cold L2: a 64 MB buffer written before every launch
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    warm_ms = named_kernel_ms(kernel, "fused_corr_groups")
    cold_ms = named_kernel_ms(kernel, "fused_corr_groups",
                              between=lambda: flush.fill_(1.0))
    del flush
    # the entry point as the GN loop calls it at refresh 1 (bucket ids + kernel)
    entry = {name: call_ms(lambda: fc.fused_normal_equations(g, scan, m, pose,
                                                             **kw))
             for name, g, m in (("full", grid, mask), ("half-masked", grid, half),
                                ("empty-map", empty, mask))}
    bound_ms, bound_by, n_bytes, flop, n_rows = kernel_bound(grid.table, hh_now,
                                                             scan, mask)
    fmt = lambda xs: ", ".join(f"{x:.4f}" for x in xs)
    print("kernel timing, device ms per call (torch.profiler): plain, v1, "
          f"kernel, kernel, v1, plain = {fmt(on_device)}", flush=True)
    print("kernel timing, ms per call as the caller sees it (CUDA events over "
          "back-to-back calls; v1 with its wrapper's unpacking): plain, v1, "
          f"kernel, kernel, v1, plain = {fmt(per_call)}; "
          "bucket ids + kernel: " + ", ".join(f"{k} {v:.4f}"
                                              for k, v in entry.items()),
          flush=True)
    ms = min(on_device[2:4])
    print(f"kernel alone (fused_corr_groups, torch.profiler): warm {warm_ms:.4f} "
          f"ms, cold L2 {cold_ms:.4f} ms", flush=True)
    print(f"kernel bound: {n_rows} distinct bucket rows, {n_bytes} bytes, "
          f"{flop} FLOP -> {bound_ms:.5f} ms by {bound_by}; time over bound: "
          f"warm {ms / bound_ms:.2f}, cold {cold_ms / bound_ms:.2f}, v1 "
          f"{min(on_device[1], on_device[4]) / bound_ms:.2f}", flush=True)
    return {"max_abs_err": max(errs), "ms": ms,
            "plain_ms": min(on_device[0], on_device[5]),
            "v1_ms": min(on_device[1], on_device[4]), "cold_ms": cold_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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

    fc.KERNEL_LAUNCHES = 0
    results, stamps = [], []
    t0 = time.perf_counter()
    for i in range(len(scans)):
        results.append(runner.process_scan(scans[i], imu=imus[i]))
        stamps.append(time.perf_counter())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = fc.KERNEL_LAUNCHES

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
    host = {k: round(v, 3) for k, v in runner.timer.mean_ms().items()}
    print(f"mission stages, host ms/scan (unsynchronized): {json.dumps(host)}",
          flush=True)

    carried_phase(dev, cfg, scans, imus, fixture)
    profiled_phase(dev, cfg, scans, imus, profile_dir)
    return launches


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
    busy_ms = device_busy_ms(prof)
    rows = prof.key_averages()
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
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        with open(os.path.join(profile_dir, "mission_profile.txt"), "w") as f:
            f.write(rows.table(sort_by="cuda_time_total", row_limit=40))
        print(f"profile table written to {profile_dir}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile-dir", default=None,
                    help="also write the torch.profiler table of scans 10-19 "
                         "here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from lio_slam_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} on {name}",
          flush=True)

    t0 = time.perf_counter()
    _build.load_fused_corr()
    built = ("an existing build" if _build.BUILD_SECONDS is None
             else f"nvcc {_build.BUILD_SECONDS:.2f} s")
    print(f"kernel library ready in {time.perf_counter() - t0:.2f} s ({built})",
          flush=True)
    for line in _build.BUILD_LOG.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    k = kernel_phase(dev)
    launches = mission_phase(dev, args.profile_dir)
    print(json.dumps({"kernels": [{
        "name": "fused_corr", "route": "cuda",
        "source": "lio_slam_tpu_torch/ops/csrc/fused_corr.cu",
        "replaces": "lio_slam_tpu/ops/fused_corr.py:124",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None, "v1_ms": k["v1_ms"],
        "cold_ms": k["cold_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
