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
    puts on the card, summed by torch.profiler over `reps` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return device_busy_ms(prof) / reps


def kernel_phase(dev):
    import numpy as np
    import torch

    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.ops import fused_corr as fc
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

    Rg, tg = se3.pose6_to_Rt(torch.from_numpy(pose0).to(dev))
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

    # kernel against plain version on held bucket ids, in turns (plain,
    # kernel, kernel, plain); L2-warm, as inside the GN loop
    hh_now = vg.bucket_ids(se3.transform_points(*se3.pose6_to_Rt(pose), scan),
                           grid.cell_size, TABLE)
    kernel = lambda: fc.fused_ne_from_bucket_ids(grid.table, hh_now, scan, mask,
                                                 pose, **kw)
    plain = lambda: fc.fused_ne_from_bucket_ids_ref(grid.table, hh_now, scan,
                                                    mask, pose, **kw)
    on_device = [device_ms(plain), device_ms(kernel), device_ms(kernel),
                 device_ms(plain)]
    per_call = [call_ms(plain, reps=10), call_ms(kernel), call_ms(kernel),
                call_ms(plain, reps=10)]
    # the entry point as the GN loop calls it at refresh 1 (bucket ids + kernel)
    entry = {name: call_ms(lambda: fc.fused_normal_equations(g, scan, m, pose,
                                                             **kw))
             for name, g, m in (("full", grid, mask), ("half-masked", grid, half),
                                ("empty-map", empty, mask))}
    fmt = lambda xs: ", ".join(f"{x:.4f}" for x in xs)
    print("kernel timing, device ms per call (torch.profiler): plain, kernel, "
          f"kernel, plain = {fmt(on_device)}", flush=True)
    print("kernel timing, ms per call as the caller sees it (CUDA events over "
          f"back-to-back calls): plain, kernel, kernel, plain = {fmt(per_call)}; "
          "bucket ids + kernel: " + ", ".join(f"{k} {v:.4f}"
                                              for k, v in entry.items()),
          flush=True)
    return {"max_abs_err": max(errs), "ms": min(on_device[1:3]),
            "plain_ms": min(on_device[0], on_device[3])}


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
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    k = kernel_phase(dev)
    launches = mission_phase(dev, args.profile_dir)
    print(json.dumps({"kernels": [{
        "name": "fused_corr", "route": "cuda",
        "source": "lio_slam_tpu_torch/ops/csrc/fused_corr.cu",
        "replaces": "lio_slam_tpu/ops/fused_corr.py:124",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
