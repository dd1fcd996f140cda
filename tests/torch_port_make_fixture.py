"""Record the JAX reference run of chip_smoke.py's mission as a fixture.

chip_smoke.py holds the PyTorch port on the GPU to the JAX package's
trajectory without importing jax.  This script runs the JAX `Runner` on the
CPU over exactly that mission (the port's `bench_config()`, 40 scans of
32768 points, seed 0, speed 2 m/s, the synthetic IMU windows) and saves the
per-scan poses, keyframe flags, GN iteration counts, the keyframe count and
the IMU front-end state each scan starts from.

On the CPU the JAX registration takes its unfused path, which finds fresh
correspondences at every GN iteration whatever `corr_refresh_every` says
(`registration._maybe_fused` returns None there).  The mission runs
`corr_refresh_every=2`, so this script gives the registration the fused
path it takes off the CPU, with the Pallas kernel in interpret mode and the
candidate block held between refreshes, as the port does.

Run by hand from the repository root (about a minute on a CPU):

    python tests/torch_port_make_fixture.py

It is not a test (pytest does not collect it).
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from lio_slam_tpu import config as jax_config  # noqa: E402
from lio_slam_tpu.ops import fused_corr as jfc  # noqa: E402
from lio_slam_tpu.ops import registration as jreg  # noqa: E402
from lio_slam_tpu.pipeline.runner import Runner  # noqa: E402
from lio_slam_tpu.utils import se3 as jse3  # noqa: E402
from lio_slam_tpu_torch.io import synthetic  # noqa: E402
from lio_slam_tpu_torch.pipeline import synthetic_mission as sm  # noqa: E402

sys.path.insert(0, os.path.join(ROOT, "tests"))
from torch_port_helpers import to_jax_config  # noqa: E402

OUT = os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                   "smoke_mission_jax.npz")


def fused_interpret(scan, scan_mask, grid, cfg):
    """`registration._maybe_fused` as it is off the CPU, with the Pallas
    kernel in interpret mode."""
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


def main():
    jreg._maybe_fused = fused_interpret
    cfg = sm.bench_config()
    seq = synthetic.make_sequence(n_scans=sm.SMOKE_SCANS,
                                  n_points=sm.SMOKE_POINTS,
                                  seed=sm.SMOKE_SEED, speed=sm.SMOKE_SPEED)
    scans, imus = sm.synthetic_inputs(seq, cfg)
    runner = Runner(to_jax_config(cfg, jax_config))
    iters = []
    step = runner.step

    def counting_step(state, inp):
        state, out = step(state, inp)
        iters.append(int(out.registration_iters))
        return state, out

    runner.step = counting_step
    t0 = time.time()
    results, imu_states = [], []
    for i in range(len(scans)):
        imu_states.append(jax.tree.map(np.array, runner.imu_state))
        results.append(runner.process_scan(scans[i], imu=imus[i]))
    poses = np.stack([r.pose for r in results]).astype(np.float32)
    ate = synthetic.ate_rmse(poses, sm.relative_truth(seq))
    stack = lambda f: np.stack([f(s) for s in imu_states])
    np.savez(OUT, poses=poses,
             is_keyframe=np.array([r.is_keyframe for r in results]),
             registration_iters=np.array(iters, np.int32),
             keyframes=np.int32(int(runner.state.store.count)),
             ate_rmse_m=np.float32(ate),
             imu_R=stack(lambda s: s.nav.R), imu_p=stack(lambda s: s.nav.p),
             imu_v=stack(lambda s: s.nav.v),
             imu_bias_gyr=stack(lambda s: s.bias_gyr),
             imu_bias_acc=stack(lambda s: s.bias_acc),
             imu_cov=stack(lambda s: s.cov),
             imu_initialized=stack(lambda s: s.initialized),
             imu_failure=stack(lambda s: s.failure))
    print(f"wrote {OUT}: {len(results)} scans, "
          f"{int(runner.state.store.count)} keyframes, ATE {ate:.5f} m, "
          f"{sum(iters)} GN iterations, {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
