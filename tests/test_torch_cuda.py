"""Checks of the port that need an NVIDIA GPU (marker `cuda`).

They skip without one: the CUDA kernel has no CPU mode.  This file imports
neither jax nor the JAX package, so it also runs where jax is not
installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import planar_scene, t
from lio_slam_tpu_torch.config import Config, LoopClosureConfig
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.ops import fused_corr as fc
from lio_slam_tpu_torch.ops import voxel_grid as vg
from lio_slam_tpu_torch.pipeline import synthetic_mission as sm
from lio_slam_tpu_torch.pipeline.runner import Runner

KW = dict(nn_radius=1.0, plane_dist_thresh=0.2, robust_weight_floor=0.1)
POSE = np.array([0.02, -0.01, 0.3, 0.5, -0.2, 0.1], np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def scene_on(dev, seed=0, n_map=8192, n_scan=1000):
    map_pts, scan = planar_scene(seed, n_map=n_map, n_scan=n_scan)
    grid = vg.build_grid(t(map_pts).to(dev),
                         torch.ones(n_map, dtype=torch.bool, device=dev),
                         1.0, 4096, 24)
    return grid, t(scan).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain_version(cuda, seed):
    grid, scan = scene_on(cuda, seed)
    mask = torch.ones(len(scan), dtype=torch.bool, device=cuda)
    mask[::7] = False
    pose = t(POSE).to(cuda)
    before = fc.KERNEL_LAUNCHES
    out = fc.fused_normal_equations(grid, scan, mask, pose, **KW)
    torch.cuda.synchronize()
    assert fc.KERNEL_LAUNCHES == before + 1
    ref = fc.fused_normal_equations_ref(grid, scan, mask, pose, **KW)
    assert int(out[2]) == int(ref[2]) > 100
    for i in (0, 1):
        torch.testing.assert_close(out[i], ref[i], rtol=2e-4, atol=2e-3)
    for i in (3, 4):
        torch.testing.assert_close(out[i], ref[i], rtol=1e-4, atol=1e-4)
    again = fc.fused_normal_equations(grid, scan, mask, pose, **KW)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
def test_wrapper_refuses_bad_inputs(cuda):
    grid, scan = scene_on(cuda)
    mask = torch.ones(len(scan), dtype=torch.bool, device=cuda)
    hh = vg.bucket_ids(scan, grid.cell_size, grid.table.shape[0])
    with pytest.raises(TypeError):
        fc.fused_ne_from_bucket_ids(grid.table, hh.long(), scan, mask,
                                    t(POSE).to(cuda), **KW)
    with pytest.raises(ValueError):
        fc.fused_ne_from_bucket_ids(grid.table, hh, scan, mask, t(POSE), **KW)


@pytest.mark.cuda
def test_kernel_skips_ids_outside_the_table(cuda):
    grid, scan = scene_on(cuda, seed=2)
    T = grid.table.shape[0]
    mask = torch.ones(len(scan), dtype=torch.bool, device=cuda)
    pose = t(POSE).to(cuda)
    hh = vg.bucket_ids(scan, grid.cell_size, T)
    hh[0, ::5] = T + 7
    hh[4, 1::3] = -3
    hh[8] = 2 ** 31 - 1
    out = fc.fused_ne_from_bucket_ids(grid.table, hh, scan, mask, pose, **KW)
    torch.cuda.synchronize()
    ref = fc.fused_ne_from_bucket_ids_ref(grid.table, hh, scan, mask, pose, **KW)
    assert int(out[2]) == int(ref[2]) > 0
    for i in (0, 1):
        torch.testing.assert_close(out[i], ref[i], rtol=2e-4, atol=2e-3)
    with pytest.raises(ValueError):
        fc.fused_ne_from_bucket_ids(grid.table, torch.cat([hh, hh[:1]]), scan,
                                    mask, pose, **KW)


@pytest.mark.cuda
def test_runner_goes_through_the_kernel(cuda):
    cfg = Config(loop=LoopClosureConfig(enabled=False))
    seq = synthetic.make_sequence(n_scans=6, n_points=4096, seed=0)
    scans, imus = sm.synthetic_inputs(seq, cfg)
    runner = Runner(cfg, device=cuda)
    fc.KERNEL_LAUNCHES = 0
    results = [runner.process_scan(scans[i], imu=imus[i]) for i in range(6)]
    assert fc.KERNEL_LAUNCHES == sum(r.registration_iters for r in results) > 0
    poses = np.stack([r.pose for r in results])
    assert np.isfinite(poses).all()
    assert np.abs(poses - sm.relative_truth(seq)).max() < 0.05
