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


def scene_on(dev, seed=0, n_map=8192, n_scan=1000, cap=24):
    map_pts, scan = planar_scene(seed, n_map=n_map, n_scan=n_scan)
    grid = vg.build_grid(t(map_pts).to(dev),
                         torch.ones(n_map, dtype=torch.bool, device=dev),
                         1.0, 4096, cap)
    return grid, t(scan).to(dev)


def assert_ne_close(out, ref):
    """The kernel contract: inliers exact; the sums differ only by the order
    they are taken in."""
    assert int(out[2]) == int(ref[2])
    for i in (0, 1):
        torch.testing.assert_close(out[i], ref[i], rtol=2e-4, atol=2e-3)
    for i in (3, 4):
        torch.testing.assert_close(out[i], ref[i], rtol=1e-4, atol=1e-4)


def unpack_v1(packed):
    """The first kernel's 30 packed sums as the five results."""
    iu = torch.triu_indices(6, 6, device=packed.device)
    AtA = torch.zeros((6, 6), device=packed.device)
    AtA[iu[0], iu[1]] = packed[:21]
    AtA[iu[1], iu[0]] = packed[:21]
    return AtA, packed[21:27], packed[27].to(torch.int32), packed[28], packed[29]


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
    assert int(out[2]) > 100
    assert_ne_close(out, ref)
    again = fc.fused_normal_equations(grid, scan, mask, pose, **KW)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("cap,n_scan", [(24, 1003), (10, 1000), (5, 77),
                                        (96, 500)])
def test_kernel_any_capacity_and_ragged_scan(cuda, cap, n_scan):
    """Rows that are not a multiple of 16 bytes take the 4-byte copies; a
    scan that does not fill its last batch of points ends at the edge; rows
    too wide for a full block's stages get a block of fewer warps."""
    grid, scan = scene_on(cuda, seed=3, n_scan=n_scan, cap=cap)
    mask = torch.ones(n_scan, dtype=torch.bool, device=cuda)
    pose = t(POSE).to(cuda)
    out = fc.fused_normal_equations(grid, scan, mask, pose, **KW)
    torch.cuda.synchronize()
    assert int(out[2]) > 0
    assert_ne_close(out, fc.fused_normal_equations_ref(grid, scan, mask, pose, **KW))


@pytest.mark.cuda
def test_kernel_matches_its_first_version(cuda):
    """Same five neighbours a point, so the same inliers; the sums are taken
    in another order, so close and not bit-equal.  Non-finite points, masked
    or not, contribute nothing in either, nor in the plain version on the
    same tensors."""
    grid, scan = scene_on(cuda, seed=4)
    scan[5] = float("nan")
    scan[40, 1] = float("inf")
    scan[41] = float("nan")
    mask = torch.ones(len(scan), dtype=torch.bool, device=cuda)
    mask[41] = False
    pose = t(POSE).to(cuda)
    hh = fc._bucket_ids_at(grid, torch.nan_to_num(scan), pose, "z")
    before = fc.KERNEL_LAUNCHES
    v1 = unpack_v1(fc.fused_ne_from_bucket_ids_v1(grid.table, hh, scan, mask,
                                                  pose, **KW))
    assert fc.KERNEL_LAUNCHES == before           # the yardstick is not counted
    out = fc.fused_ne_from_bucket_ids(grid.table, hh, scan, mask, pose, **KW)
    torch.cuda.synchronize()
    assert int(out[2]) > 100 and bool(torch.isfinite(out[0]).all())
    assert_ne_close(out, v1)
    assert_ne_close(out, fc.fused_ne_from_bucket_ids_ref(
        grid.table, hh, scan, mask, pose, **KW))


@pytest.mark.cuda
def test_outputs_are_views_of_one_buffer(cuda):
    grid, scan = scene_on(cuda)
    mask = torch.ones(len(scan), dtype=torch.bool, device=cuda)
    AtA, Atb, n_inl, wsum, wres = fc.fused_normal_equations(
        grid, scan, mask, t(POSE).to(cuda), **KW)
    torch.cuda.synchronize()
    assert AtA.shape == (6, 6) and Atb.shape == (6,)
    assert n_inl.shape == wsum.shape == wres.shape == ()
    assert n_inl.dtype == torch.int32
    assert all(x.dtype == torch.float32 for x in (AtA, Atb, wsum, wres))
    assert torch.equal(AtA, AtA.T) and float(AtA.abs().sum()) > 0
    base = AtA.untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() == base
               for x in (Atb, n_inl, wsum, wres))


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
    # the same table 4 bytes off a 16-byte boundary
    T, C, _ = grid.table.shape
    shifted = torch.empty(T * C * 3 + 1, device=cuda)[1:].view(T, C, 3)
    shifted.copy_(grid.table)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        fc.fused_ne_from_bucket_ids(shifted, hh, scan, mask, t(POSE).to(cuda),
                                    **KW)


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
    assert int(out[2]) > 0
    assert_ne_close(out, ref)
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
