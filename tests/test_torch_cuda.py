"""Checks of the port that need an NVIDIA GPU (marker `cuda`).

They skip without one: the CUDA kernel has no CPU mode.  This file imports
neither jax nor the JAX package, so it also runs where jax is not
installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import (GN_SMALL_CASES, WINDOW_CASES,
                                assert_same_bits, assert_window_close,
                                gn_small_case, planar_scene,
                                streamed_stage_case, t, window_case,
                                window_pose_atol, window_truth)
from lio_slam_tpu_torch.config import Config, LoopClosureConfig
from lio_slam_tpu_torch.graph import solver
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.ops import fused_corr as fc
from lio_slam_tpu_torch.ops import gn_small as gn
from lio_slam_tpu_torch.ops import voxel_grid as vg
from lio_slam_tpu_torch.ops import window_system as ws
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
@pytest.mark.parametrize("halo,cap", [("full", 64), ("full", 128), ("xy", 72),
                                      ("none", 24), ("none", 22), ("none", 5),
                                      ("none", 96)])
def test_kernel_at_every_layout(cuda, halo, cap):
    """The instantiations at 1, 3 and 27 bucket ids a point against the
    plain version; repeated launches bit-identical.  At 27 ids the rows
    stream through the stage in chunks of 9 offsets: a cap that is no
    multiple of 4 takes the 4-byte copies (22; at 5 a chunk's 45 rows also
    move a lane's rows from one chunk to the next), a wide one (96) a block
    of fewer warps.  At 1 and 3 ids the entry point passes the grid's
    counts, and the kernel copies and ranks only each row's filled
    prefix: bit-equal to the same launch on whole rows."""
    map_pts, scan = planar_scene(6, n_map=8192, n_scan=1000)
    grid = vg.build_grid(t(map_pts).to(cuda),
                         torch.ones(len(map_pts), dtype=torch.bool, device=cuda),
                         1.0, 4096, cap, halo=halo)
    scan = t(scan).to(cuda)
    mask = torch.ones(len(scan), dtype=torch.bool, device=cuda)
    mask[3::11] = False
    pose = t(POSE).to(cuda)
    before = fc.KERNEL_LAUNCHES
    out = fc.fused_normal_equations(grid, scan, mask, pose, halo=halo, **KW)
    torch.cuda.synchronize()
    assert fc.KERNEL_LAUNCHES == before + 1
    ref = fc.fused_normal_equations_ref(grid, scan, mask, pose, halo=halo, **KW)
    assert int(out[2]) > 100
    assert_ne_close(out, ref)
    again = fc.fused_normal_equations(grid, scan, mask, pose, halo=halo, **KW)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    hh = fc._bucket_ids_at(grid, scan, pose, halo)
    whole = fc.fused_ne_from_bucket_ids(grid.table, hh, scan, mask, pose, **KW)
    filled = fc.fused_ne_from_bucket_ids(grid.table, hh, scan, mask, pose, **KW,
                                         counts=grid.counts)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, filled))
    assert all(torch.equal(a, b) for a, b in zip(whole, filled))


@pytest.mark.cuda
@pytest.mark.parametrize("halo,cap", [("full", 64), ("full", 128), ("xy", 72),
                                      ("xy", 70)])
def test_kernel_filled_prefix_on_wrapped_and_sparse_rows(cuda, halo, cap):
    """At 1 and 3 ids a point, on a dense map inserted in chunks (rows full
    after ring overwrites) and on a sparse one (empty rows, points with
    fewer than five filled slots), with ids repeated, below 0 and past the
    table: `counts` against the plain version and bit-equal to whole
    rows; cap 70 takes the 4-byte copies."""
    for n_map, n_scan in ((32768, 1000), (512, 400)):
        map_pts, scan = planar_scene(6, n_map=n_map, n_scan=n_scan)
        grid = vg.build_grid(t(map_pts).to(cuda),
                             torch.ones(n_map, dtype=torch.bool, device=cuda),
                             1.0, 4096, cap, halo=halo, chunk=4096)
        scan = t(scan).to(cuda)
        mask = torch.ones(len(scan), dtype=torch.bool, device=cuda)
        mask[3::11] = False
        pose = t(POSE).to(cuda)
        hh = fc._bucket_ids_at(grid, scan, pose, halo).clone()
        hh[-1, 0::5] = -1
        hh[0, 1::7] = 4096
        if halo == "xy":
            hh[1, 0::3] = hh[0, 0::3]
        args = (grid.table, hh, scan, mask, pose)
        out = fc.fused_ne_from_bucket_ids(*args, **KW, counts=grid.counts)
        whole = fc.fused_ne_from_bucket_ids(*args, **KW)
        torch.cuda.synchronize()
        assert_ne_close(out, fc.fused_ne_from_bucket_ids_ref(*args, **KW))
        assert all(torch.equal(a, b) for a, b in zip(out, whole))
        if n_map == 32768:
            assert int((grid.counts == cap).sum()) > 500 and int(out[2]) > 100


@pytest.mark.cuda
def test_wrapper_refuses_counts_that_are_not_the_grids(cuda):
    """`counts` must be the grid's (T,) int32 buffer on the card."""
    grid, scan = scene_on(cuda, cap=64)
    mask = torch.ones(len(scan), dtype=torch.bool, device=cuda)
    pose = t(POSE).to(cuda)
    hh = fc._bucket_ids_at(grid, scan, pose, "z")[:1].contiguous()
    before = fc.KERNEL_LAUNCHES
    for bad, err in ((grid.counts.long(), TypeError),
                     (grid.counts[:-1], ValueError),
                     (grid.counts.cpu(), ValueError)):
        with pytest.raises(err):
            fc.fused_ne_from_bucket_ids(grid.table, hh, scan, mask, pose, **KW,
                                        counts=bad)
    assert fc.KERNEL_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [24, 22])
@pytest.mark.parametrize("case", ["tie", "last_chunk", "duplicates"])
def test_kernel_streamed_stage_cases(cuda, case, cap):
    """The 27-id instantiation against the plain version on the cases the
    streamed stage makes new (`streamed_stage_case`), at a cap that is a
    multiple of 4 and one that is not (the 4-byte copies): inliers exact,
    sums as the kernel contract allows, repeated launches bit-identical.
    Most points are inliers, so a wrong fifth neighbour would show."""
    args = [x.to(cuda) for x in streamed_stage_case(case, cap)]
    out = fc.fused_ne_from_bucket_ids(*args, **KW)
    torch.cuda.synchronize()
    ref = fc.fused_ne_from_bucket_ids_ref(*args, **KW)
    assert int(ref[2]) > len(args[2]) // 2
    assert_ne_close(out, ref)
    again = fc.fused_ne_from_bucket_ids(*args, **KW)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    # the plain version on the CPU selects the same rows
    cpu = fc.fused_ne_from_bucket_ids_ref(*(x.cpu() for x in args), **KW)
    assert int(cpu[2]) == int(out[2])


@pytest.mark.cuda
def test_wrapper_refuses_other_offset_counts_and_narrow_buckets(cuda):
    """No instantiation for 2 or 10 ids a point, none for fewer than 5
    slots a bucket: the wrapper raises, it never runs the plain version."""
    grid, scan = scene_on(cuda)
    mask = torch.ones(len(scan), dtype=torch.bool, device=cuda)
    pose = t(POSE).to(cuda)
    hh = vg.bucket_ids(scan, grid.cell_size, grid.table.shape[0])
    before = fc.KERNEL_LAUNCHES
    for ids in (hh[:2], torch.cat([hh, hh[:1]])):
        with pytest.raises(ValueError, match="buckets per point"):
            fc.fused_ne_from_bucket_ids(grid.table, ids.contiguous(), scan,
                                        mask, pose, **KW)
    with pytest.raises(ValueError, match="slots a bucket"):
        fc.fused_ne_from_bucket_ids(grid.table[:, :4].contiguous(), hh, scan,
                                    mask, pose, **KW)
    assert fc.KERNEL_LAUNCHES == before


@pytest.mark.cuda
def test_kernel_ignores_non_finite_points(cuda):
    """Non-finite points, masked or not, contribute nothing, in the kernel
    as in the plain version on the same tensors."""
    grid, scan = scene_on(cuda, seed=4)
    scan[5] = float("nan")
    scan[40, 1] = float("inf")
    scan[41] = float("nan")
    mask = torch.ones(len(scan), dtype=torch.bool, device=cuda)
    mask[41] = False
    pose = t(POSE).to(cuda)
    hh = fc._bucket_ids_at(grid, torch.nan_to_num(scan), pose, "z")
    out = fc.fused_ne_from_bucket_ids(grid.table, hh, scan, mask, pose, **KW)
    torch.cuda.synchronize()
    assert int(out[2]) > 100 and bool(torch.isfinite(out[0]).all())
    assert_ne_close(out, fc.fused_ne_from_bucket_ids_ref(
        grid.table, hh, scan, mask, pose, **KW))


def keyframe_submap(dev, n_keyframes=9, points=2048, capacity=8192):
    """A keyframe store along a 16 m path through the planar scene, the
    submap around its middle keyframe as loop verification builds it, and
    the last keyframe's cloud and pose as the scan."""
    from lio_slam_tpu_torch.pipeline import keyframes as kf
    from lio_slam_tpu_torch.pipeline import loop_closure
    from lio_slam_tpu_torch.utils import pointcloud as pc
    from lio_slam_tpu_torch.utils import se3

    rs = np.random.RandomState(0)
    world, _ = planar_scene(1, n_map=32768, n_scan=8)
    store = kf.empty_store(16, points, device=dev)
    for k in range(n_keyframes):
        pose = np.array([0.01, -0.01, 0.05 * k, 2.0 * k - 8.0, 0.3 * k, 1.0],
                        np.float32)
        near = world[np.linalg.norm(world[:, :2] - pose[3:5], axis=1) < 12.0]
        pts = near[rs.permutation(len(near))[:points - 200]]   # a masked tail
        R, tr = se3.pose6_to_Rt(t(pose))
        body = ((t(pts) - tr) @ R).to(dev)
        mask = torch.zeros(points, dtype=torch.bool, device=dev)
        mask[:len(pts)] = True
        cloud = torch.zeros((points, 3), device=dev)
        cloud[:len(pts)] = body
        store = kf.add_keyframe(store, t(pose).to(dev),
                                torch.tensor(float(k), device=dev),
                                pc.Cloud(xyz=cloud, mask=mask))
    submap = loop_closure._submap_around(store, torch.tensor(4, device=dev), 3,
                                         capacity, 0.4)
    last = n_keyframes - 1
    return store, submap, store.clouds[last], store.cloud_masks[last], \
        store.poses[last]


@pytest.mark.cuda
@pytest.mark.parametrize("table", [4096, 32768])
def test_kernel_on_a_submap_grid_with_a_keyframe_scan(cuda, table):
    """The kernel the way loop verification launches it: a table built in
    one shot by `build_grid` over a downsampled submap (many rows hold one or
    two points, and in the large table most rows are empty), a keyframe
    cloud with its masked tail as the scan."""
    _, submap, scan, mask, pose = keyframe_submap(cuda)
    grid = vg.build_grid(submap.xyz, submap.mask, 1.0, table, 24, halo="z")
    assert 1000 < int(submap.mask.sum()) and not bool(mask.all())
    out = fc.fused_normal_equations(grid, scan, mask, pose, **KW)
    torch.cuda.synchronize()
    assert int(out[2]) > 100
    assert_ne_close(out, fc.fused_normal_equations_ref(grid, scan, mask, pose, **KW))


@pytest.mark.cuda
def test_register_launches_the_kernel_once_a_gn_iteration(cuda):
    from lio_slam_tpu_torch.config import RegistrationConfig
    from lio_slam_tpu_torch.ops import registration as reg

    _, submap, scan, mask, pose = keyframe_submap(cuda)
    # the scene (a ground plane and one wall) does not constrain y
    init = pose + torch.tensor([0.0, 0.0, 0.01, 0.1, 0.0, 0.02], device=cuda)
    for refresh in (1, 2):
        fc.KERNEL_LAUNCHES = 0
        r = reg.register(scan, mask, submap.xyz, submap.mask, init,
                         RegistrationConfig(corr_refresh_every=refresh))
        assert fc.KERNEL_LAUNCHES == r.iterations > 1
        assert float((r.pose - pose).abs().max()) < 0.05
    # below the point gates nothing is launched and the guess comes back
    fc.KERNEL_LAUNCHES = 0
    few = torch.zeros_like(mask)
    few[:20] = True
    r = reg.register(scan, few, submap.xyz, submap.mask, init, RegistrationConfig())
    assert fc.KERNEL_LAUNCHES == 0 and r.iterations == 0
    assert torch.equal(r.pose, init)


@pytest.mark.cuda
@pytest.mark.parametrize("case", GN_SMALL_CASES)
def test_gn_small_matches_smallmat_on_the_card(cuda, case):
    """The GN step's kernel against `smallmat.cholesky_solve(eps=1e-6)` and
    `smallmat.eigh_jacobi` run as torch ops on the same CUDA tensors, word
    for word (a NaN may be any NaN): both instantiations, one launch each;
    a repeated launch gives the same words."""
    from lio_slam_tpu_torch.utils import smallmat

    AtA, Atb = (t(x).to(cuda) for x in gn_small_case(case))
    dx = smallmat.cholesky_solve(AtA, Atb, eps=1e-6)
    w, V = smallmat.eigh_jacobi(AtA)
    before = gn.KERNEL_LAUNCHES, gn.EIGH_LAUNCHES
    got_dx = gn.solve(AtA, Atb)
    got = gn.solve_eigh(AtA, Atb)
    again = gn.solve_eigh(AtA, Atb)
    torch.cuda.synchronize()
    assert (gn.KERNEL_LAUNCHES, gn.EIGH_LAUNCHES) == (before[0] + 3,
                                                      before[1] + 2)
    assert_same_bits(got_dx.cpu(), dx.cpu())
    for a, b, c in zip(got, (dx, w, V), again):
        assert a.device.type == "cuda"
        assert_same_bits(a.cpu(), b.cpu())
        assert_same_bits(c.cpu(), a.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64", "batched", "Atb_on_the_host"])
def test_gn_small_refuses_what_the_kernel_does_not_take(cuda, bad):
    """A CUDA input the kernel does not take raises; nothing launches and
    the plain version does not run in its place."""
    AtA, Atb = (t(x).to(cuda) for x in gn_small_case("spd_0"))
    if bad == "float64":
        AtA, Atb = AtA.double(), Atb.double()
    elif bad == "batched":
        AtA, Atb = AtA[None], Atb[None]
    else:
        Atb = Atb.cpu()
    before = gn.KERNEL_LAUNCHES, gn.EIGH_LAUNCHES
    for fn in (gn.solve, gn.solve_eigh):
        with pytest.raises(ValueError, match="float32"):
            fn(AtA, Atb)
    assert (gn.KERNEL_LAUNCHES, gn.EIGH_LAUNCHES) == before


@pytest.mark.cuda
def test_gn_small_in_a_cuda_graph(cuda):
    """Both launches captured in one CUDA graph (they count as captured,
    not as launches) and replayed on new inputs copied into the static
    ones: the same words as eager launches on those inputs."""
    AtA, Atb = (t(x).to(cuda) for x in gn_small_case("spd_0"))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gn.solve_eigh(AtA, Atb)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    counts = (gn.KERNEL_LAUNCHES, gn.CAPTURED_LAUNCHES,
              gn.CAPTURED_EIGH_LAUNCHES)
    with torch.cuda.graph(graph):
        first = gn.solve_eigh(AtA, Atb)
        dx = gn.solve(AtA, Atb)
    assert (gn.KERNEL_LAUNCHES, gn.CAPTURED_LAUNCHES,
            gn.CAPTURED_EIGH_LAUNCHES) == (counts[0], counts[1] + 2,
                                           counts[2] + 1)
    for case in ("gn_plane", "rank_deficient", "spd_1"):
        A2, b2 = (t(x).to(cuda) for x in gn_small_case(case))
        AtA.copy_(A2)
        Atb.copy_(b2)
        graph.replay()
        eager = gn.solve_eigh(A2, b2)
        torch.cuda.synchronize()
        assert_same_bits(dx.cpu(), eager[0].cpu())
        for a, b in zip(first, eager):
            assert_same_bits(a.cpu(), b.cpu())


def window_graph_on(dev, case):
    graph, count, W = window_case(case)
    return (type(graph)(*(x.to(dev) for x in graph)), count.to(dev), W), \
        (graph, count, W)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WINDOW_CASES)
def test_window_system_matches_the_plain_version_on_the_card(cuda, case):
    """The window-system kernel against the plain version on the CPU and
    its float64 form, blockwise (`torch_port_helpers.assert_window_close`);
    one launch a system, H symmetric bit for bit, a second launch the same
    bits; then `solve_window_compact` on the card, two launches, its poses
    within the CPU tests' bounds of the CPU solve's."""
    on_card, on_cpu = window_graph_on(cuda, case)
    before = ws.KERNEL_LAUNCHES
    H, b = ws.assemble(*on_card)
    again = ws.assemble(*on_card)
    torch.cuda.synchronize()
    assert ws.KERNEL_LAUNCHES == before + 2
    assert H.device.type == "cuda" and H.dtype == torch.float32
    assert torch.equal(H, again[0]) and torch.equal(b, again[1])
    assert torch.equal(H, H.T)
    assert_window_close((H.cpu(), b.cpu()),
                        solver.assemble_window_plain(*on_cpu),
                        on_cpu[2], truth=window_truth(case, *on_cpu))
    got = solver.solve_window_compact(*on_card, iterations=2)
    ref = solver.solve_window_compact(*on_cpu, iterations=2)
    assert ws.KERNEL_LAUNCHES == before + 4
    torch.testing.assert_close(got.poses.cpu(), ref.poses, rtol=0,
                               atol=window_pose_atol(case, *on_cpu[1:]))


@pytest.mark.cuda
def test_window_system_in_a_cuda_graph(cuda):
    """Two window-solve iterations captured in one CUDA graph (they count as
    captured, not as launches) and replayed on other graphs copied into the
    static leaves: the same words as eager solves on those graphs."""
    (graph, count, W), _ = window_graph_on(cuda, "loops")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        solver.solve_window_compact(graph, count, W, iterations=2)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    cuda_graph = torch.cuda.CUDAGraph()
    counts = ws.KERNEL_LAUNCHES, ws.CAPTURED_LAUNCHES
    with torch.cuda.graph(cuda_graph):
        out = solver.solve_window_compact(graph, count, W, iterations=2)
    assert (ws.KERNEL_LAUNCHES, ws.CAPTURED_LAUNCHES) == (counts[0],
                                                          counts[1] + 2)
    for case in ("chain", "gps", "loops"):
        (other, other_count, _), _ = window_graph_on(cuda, case)
        for dst, src in zip(graph, other):
            dst.copy_(src)
        count.copy_(other_count)
        cuda_graph.replay()
        eager = solver.solve_window_compact(other, other_count, W,
                                            iterations=2)
        torch.cuda.synchronize()
        assert_same_bits(out.poses.cpu(), eager.poses.cpu())


@pytest.mark.cuda
def test_window_system_refuses_what_the_kernel_does_not_take(cuda):
    """A CUDA graph with int64 indices, float64 poses, a leaf on the CPU,
    a float count or a window over MAX_WINDOW raises ValueError."""
    (graph, count, W), _ = window_graph_on(cuda, "chain")
    bad = [(graph._replace(bt_i=graph.bt_i.long()), count, W),
           (graph._replace(poses=graph.poses.double()), count, W),
           (graph._replace(gps_mask=graph.gps_mask.cpu()), count, W),
           (graph, count.float(), W),
           (graph, count, ws.MAX_WINDOW + 1)]
    for args in bad:
        with pytest.raises(ValueError):
            ws.assemble(*args)


@pytest.mark.cuda
def test_loop_mission_on_the_card_is_repeatable(cuda):
    """Loop closure and GPS through `Runner` on the card: launches equal the
    GN iterations of mapping plus verification, and two runs give the same
    bits (no sum on this path is accumulated with atomics)."""
    import dataclasses

    from lio_slam_tpu_torch.config import GpsConfig

    cfg = dataclasses.replace(
        Config(), loop=LoopClosureConfig(enabled=True, archive_enabled=False,
                                         time_diff=0.8, sc_exclude_recent=3),
        gps=GpsConfig(use_gps=True, pose_cov_threshold=-1.0,
                      gps_distance_frequency=2.0, min_travel_before_gps=1.0),
        static=dataclasses.replace(Config().static, max_keyframes=64,
                                   max_keyframe_points=2048))
    seq = synthetic.make_sequence(n_scans=20, n_points=4096, seed=0, speed=3.0)
    scans, imus = sm.synthetic_inputs(seq, cfg)
    fixes = synthetic.gps_fixes_from_truth(
        sm.relative_truth(seq)[:, 3:].astype(np.float64), seq.stamps, seed=4)
    runs = []
    for _ in range(2):
        runner = Runner(cfg, loop_every=6)
        assert runner.device.type == "cuda"
        fc.KERNEL_LAUNCHES = gn.KERNEL_LAUNCHES = ws.KERNEL_LAUNCHES = 0
        results, ver = [], 0
        for i in range(20):
            results.append(runner.process_scan(scans[i], imu=imus[i],
                                               gps_fixes=fixes[i]))
            if (i + 1) % 6 == 0:
                ver += sum(runner.last_loop_aux["loop_iters"])
        assert ver > 0 and fc.KERNEL_LAUNCHES \
            == sum(r.registration_iters for r in results) + ver
        assert gn.KERNEL_LAUNCHES == fc.KERNEL_LAUNCHES
        assert ws.KERNEL_LAUNCHES == 2 * sum(r.is_keyframe for r in results)
        assert int(runner.state.gps_count) >= 1 and runner.full_correction_scans
        runs.append(np.stack([r.pose for r in results]))
    assert np.isfinite(runs[0]).all()
    np.testing.assert_array_equal(runs[0], runs[1])


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
    fc.KERNEL_LAUNCHES = gn.KERNEL_LAUNCHES = gn.EIGH_LAUNCHES = 0
    ws.KERNEL_LAUNCHES = 0
    results = [runner.process_scan(scans[i], imu=imus[i]) for i in range(6)]
    assert fc.KERNEL_LAUNCHES == sum(r.registration_iters for r in results) > 0
    # every GN pass takes its step in one launch, the first with the
    # eigensolve: one a registration that ran
    assert gn.KERNEL_LAUNCHES == fc.KERNEL_LAUNCHES
    assert gn.EIGH_LAUNCHES == sum(r.registration_iters > 0 for r in results) > 0
    # the keyframe save's window solve: one launch an iteration, two a save
    assert ws.KERNEL_LAUNCHES == 2 * sum(r.is_keyframe for r in results) > 0
    poses = np.stack([r.pose for r in results])
    assert np.isfinite(poses).all()
    assert np.abs(poses - sm.relative_truth(seq)).max() < 0.05


def circuit_state(dev, n_scans=11, seed=3):
    """The port's mapping step over a circuit of 2048-point scans on `dev`
    (five keyframes at seeds 0 and 3): a state whose newest keyframe
    registers against the world points of all of them.  At seed 3 that
    registration runs all its GN passes unconverged, on the CPU and on the
    card; at seed 0 it converges in 3 passes, and in 3 to 5 with every
    keyframe pose moved by 1e-6 to 1e-5 m (CPU)."""
    from lio_slam_tpu_torch.config import RegistrationConfig, StaticConfig
    from lio_slam_tpu_torch.pipeline import lio
    from lio_slam_tpu_torch.utils import pointcloud as pc

    cfg = Config(static=StaticConfig(max_raw_points=2048, max_scan_points=2048,
                                     max_map_points=8192, max_keyframes=16,
                                     max_keyframe_points=1024, max_loop_queue=2,
                                     max_gps_queue=2, window_size=8,
                                     max_archive_anchors=2),
                 registration=RegistrationConfig(degeneracy_eig_thresh=10.0),
                 loop=LoopClosureConfig(search_num=3))
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=seed,
                                  speed=2.0, yaw_rate=2 * np.pi / 4.5)
    step = lio.make_lio_step(cfg, device=dev)
    state = lio.init_state(cfg, device=dev)
    on = lambda x: t(x).to(dev)
    for i in range(n_scans):
        state, _ = step(state, lio.ScanInput(
            cloud=pc.Cloud(xyz=on(seq.scans[i]), mask=on(seq.scan_masks[i])),
            stamp=on(np.float32(seq.stamps[i])), init_guess=on(np.zeros(6, np.float32)),
            guess_valid=on(np.bool_(False)), imu_rpy=on(seq.imu_rpy[i]),
            imu_available=on(np.bool_(True)), gps_pos=on(np.zeros(3, np.float32)),
            gps_info=on(np.zeros(3, np.float32)), gps_valid=on(np.bool_(False))))
    return cfg, seq, state


def counted_registrations(monkeypatch):
    """Wrap `registration.register` to record each call's GN iterations."""
    from lio_slam_tpu_torch.ops import registration as reg

    iters, real = [], reg.register

    def counting(*a, **k):
        r = real(*a, **k)
        iters.append(r.iterations)
        return r

    monkeypatch.setattr(reg, "register", counting)
    return iters


@pytest.mark.cuda
def test_archive_verifier_on_the_card(cuda, monkeypatch):
    """Archive verification through the kernel: one launch a GN iteration,
    the gate decision, fitness and slots of the same state on the CPU."""
    from lio_slam_tpu_torch import convert
    from lio_slam_tpu_torch.pipeline import archive
    from lio_slam_tpu_torch.pipeline import keyframes as kf

    cfg, _, state = circuit_state(cuda, seed=0)
    n_kf = int(state.store.count)
    assert n_kf == 5
    world = kf.transform_keyframe_clouds(state.store)[:n_kf][state.store.cloud_masks[:n_kf]]
    cap = cfg.static.max_map_points
    xyz = torch.zeros((cap, 3), device=cuda)
    xyz[:len(world)] = world[:cap]
    mask = torch.arange(cap, device=cuda) < len(world)
    init = state.store.poses[n_kf - 1] + torch.tensor(
        [0, 0, 0.01, 0.1, -0.05, 0], device=cuda)
    iters = counted_registrations(monkeypatch)
    verify = archive.make_archive_verifier(cfg)
    fc.KERNEL_LAUNCHES = 0
    gpu, added, fit = verify(state, xyz, mask, init, 5.0)
    assert fc.KERNEL_LAUNCHES == iters[0] > 0
    cpu_state = convert.from_numpy(convert.to_numpy(state))
    cpu, added_c, fit_c = verify(cpu_state, xyz.cpu(), mask.cpu(), init.cpu(), 5.0)
    assert fc.KERNEL_LAUNCHES == iters[0]          # the CPU runs the plain version
    assert bool(added) and bool(added_c)
    assert abs(float(fit) - float(fit_c)) < 2e-3 and float(fit) < 0.3
    for a, b in ((gpu.pend_mask, cpu.pend_mask), (gpu.pend_i, cpu.pend_i),
                 (gpu.graph.gps_mask, cpu.graph.gps_mask),
                 (gpu.graph.gps_i, cpu.graph.gps_i)):
        assert torch.equal(a.cpu(), b)
    torch.testing.assert_close(gpu.graph.gps_meas.cpu(), cpu.graph.gps_meas,
                               atol=2e-3, rtol=0)


@pytest.mark.cuda
def test_relocalizer_on_the_card(cuda, monkeypatch):
    """Relocalization through the kernel: one launch a GN iteration, the
    match and the pose of the same query on the CPU."""
    from lio_slam_tpu_torch import convert
    from lio_slam_tpu_torch.pipeline import relocalization
    from lio_slam_tpu_torch.utils import pointcloud as pc

    cfg, seq, state = circuit_state(cuda)
    iters = counted_registrations(monkeypatch)
    reloc = relocalization.make_relocalizer(cfg)
    # scan 4 is the place of keyframe 2 (it relocalizes there on the CPU)
    scan = pc.Cloud(xyz=t(seq.scans[4]).to(cuda), mask=t(seq.scan_masks[4]).to(cuda))
    fc.KERNEL_LAUNCHES = 0
    r = reloc(state, scan)
    assert fc.KERNEL_LAUNCHES == iters[0] > 0
    rc = reloc(convert.from_numpy(convert.to_numpy(state)),
               pc.Cloud(xyz=scan.xyz.cpu(), mask=scan.mask.cpu()))
    assert bool(r.success) and bool(rc.success)
    assert int(r.matched_kf) == int(rc.matched_kf) == 2
    torch.testing.assert_close(r.pose.cpu(), rc.pose, atol=2e-3, rtol=0)


@pytest.mark.cuda
def test_batched_fetches_on_the_card(cuda):
    """`fetch_every=3` on the card (copies into pinned memory, read at the
    drain) gives the bits of `fetch_every=1`."""
    cfg = Config(loop=LoopClosureConfig(enabled=False))
    seq = synthetic.make_sequence(n_scans=7, n_points=4096, seed=0)
    scans, imus = sm.synthetic_inputs(seq, cfg)
    one, three = Runner(cfg, device=cuda), Runner(cfg, device=cuda, fetch_every=3)
    for i in range(7):
        one.process_scan(scans[i], imu=imus[i])
        three.process_scan(scans[i], imu=imus[i])
    assert len(three.trajectory) < 7
    three.drain()
    np.testing.assert_array_equal(np.stack(three.trajectory), np.stack(one.trajectory))


@pytest.mark.cuda
def test_bag_replay_on_the_card_matches_the_cpu(cuda, tmp_path):
    """An 8-scan bag of 2048 points (epoch stamps, skew, 9-axis IMU, GPS
    and the raw GpswithHeading stream) through `replay_bag` on the native
    queues into a recording Runner on the card and on the CPU: the same
    keyframe flags, GPS factors and recorded records, poses within 1e-3,
    and on the card one kernel launch a GN iteration."""
    import collections

    from lio_slam_tpu_torch.config import (GpsConfig, RegistrationConfig,
                                           StaticConfig)
    from lio_slam_tpu_torch.io import rosbag as rb
    from lio_slam_tpu_torch.io.bag_replay import BagTopics, replay_bag
    from lio_slam_tpu_torch.io.synthetic_bag import write_synthetic_bag

    path = str(tmp_path / "small.bag")
    write_synthetic_bag(path, n_scans=8, n_points=2048, seed=0, epoch=1.7e9,
                        scan_period=0.1, sweep_time=0.1, yaw_rate=0.6,
                        world_extent=30.0, gps=True, raw_gps_topic="/gpsdata")
    cfg = Config(
        static=StaticConfig(max_raw_points=2048, max_scan_points=2048,
                            max_map_points=8192, max_keyframes=16,
                            max_keyframe_points=1024, max_loop_queue=2,
                            max_gps_queue=8, window_size=8, max_imu_window=128),
        registration=RegistrationConfig(degeneracy_eig_thresh=10.0),
        loop=LoopClosureConfig(enabled=False),
        gps=GpsConfig(use_gps=True, pose_cov_threshold=-1.0))
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        rec = str(tmp_path / f"{dev.type}.bag")
        runner = Runner(cfg, device=dev, loop_every=100, record_bag=rec)
        before = fc.KERNEL_LAUNCHES
        results = list(replay_bag(runner, path, BagTopics(
            gps="/gps/fix", raw_gps="/gpsdata"), use_native=True))
        launches = fc.KERNEL_LAUNCHES - before
        runner.close()
        topics = collections.Counter(m.topic for m in rb.BagReader(rec).read_messages())
        runs[dev.type] = (results, launches, int(runner.state.gps_count), topics)
    (cpu, cpu_launches, cpu_gps, cpu_rec), (card, launches, gps, rec) = \
        runs["cpu"], runs["cuda"]
    assert len(card) == len(cpu) == 8
    assert cpu_launches == 0
    assert launches == sum(r.registration_iters for r in card) > 0
    assert [r.is_keyframe for r in card] == [r.is_keyframe for r in cpu]
    assert gps == cpu_gps and rec == cpu_rec
    np.testing.assert_allclose(np.stack([r.pose for r in card]),
                               np.stack([r.pose for r in cpu]), atol=1e-3)


def assert_ne_close_or_cancelling(out, args, kw):
    """The bag paths' kernel rule (chip_smoke.py `bag_kernel_check`): the
    inliers exact, the sums within rtol 1e-4, each AtA / Atb entry within
    rtol 2e-4 / atol 2e-3 of the plain version or, on entries that are
    sums that cancel, no farther from the plain version in float64 than
    that band plus four times the plain float32 version's own rounding
    there, the float64 version selecting the same inliers."""
    ref = fc.fused_ne_from_bucket_ids_ref(*args, **kw)
    ref64 = fc.fused_ne_from_bucket_ids_ref(
        *[x.double() if torch.is_tensor(x) and x.dtype == torch.float32 else x
          for x in args], **kw)
    g, r, r64 = ([x.detach().double().cpu().numpy() for x in o]
                 for o in (out, ref, ref64))
    assert int(g[2]) == int(r[2])
    for i in (3, 4):
        assert np.isclose(g[i], r[i], rtol=1e-4, atol=1e-4)
    for i in (0, 1):
        outside = np.abs(g[i] - r[i]) > 2e-3 + 2e-4 * np.abs(r[i])
        if outside.any():
            rounding = np.abs(r[i] - r64[i]).max()
            assert int(r64[2]) == int(r[2])
            assert (np.abs(g[i] - r64[i])
                    <= 2e-3 + 2e-4 * np.abs(r64[i]) + 4 * rounding).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["incremental", "rebuild"])
def test_corner_paths_on_the_card(cuda, mode, monkeypatch):
    """The LOAM corner path on the incremental and on the rebuild-mode map:
    a 6-scan sweep mission on the card goes through `fused_normal_equations`
    once a GN iteration, each launch agrees with the plain version on its
    own arguments (the bag paths' rule: the plain version in float64
    decides on entries that cancel), and the trajectory is the CPU run's."""
    from lio_slam_tpu_torch.config import (ImuConfig, RegistrationConfig,
                                           StaticConfig)

    cfg = Config(static=StaticConfig(max_raw_points=4096, max_scan_points=2048,
                                     max_map_points=16384, max_keyframes=16,
                                     max_keyframe_points=2048, max_loop_queue=2,
                                     max_gps_queue=2, window_size=8,
                                     max_imu_window=32, max_corner_points=512,
                                     max_corner_map_points=4096),
                 imu=ImuConfig(imu_rate=100.0),
                 registration=RegistrationConfig(use_corner_features=True,
                                                 local_map_mode=mode,
                                                 grid_table_size=8192),
                 loop=LoopClosureConfig(enabled=False))
    _, scans, imus = sm.corner_mission_inputs(cfg, n_scans=6, n_points=4096)
    calls = []
    entry, kernel = fc.fused_normal_equations, fc.fused_ne_from_bucket_ids

    def counted(*a, **k):
        calls.append(a[1].is_cuda)
        return entry(*a, **k)

    def checked(*a, **k):
        out = kernel(*a, **k)
        if a[0].is_cuda:
            assert_ne_close_or_cancelling(out, a, k)
        return out

    monkeypatch.setattr(fc, "fused_normal_equations", counted)
    monkeypatch.setattr(fc, "fused_ne_from_bucket_ids", checked)
    runner = Runner(cfg, device=cuda)
    fc.KERNEL_LAUNCHES = 0
    res = [runner.process_scan(scans[i], imu=imus[i]) for i in range(6)]
    launches = fc.KERNEL_LAUNCHES
    assert launches == len(calls) == sum(r.registration_iters for r in res) > 0
    assert all(calls)
    assert int(runner.state.store.corner_masks.sum()) > 0
    cpu = Runner(cfg, device="cpu")
    ref = [cpu.process_scan(scans[i], imu=imus[i]) for i in range(6)]
    dev = np.abs(np.stack([r.pose for r in res]) - np.stack([r.pose for r in ref]))
    assert dev.max() < 1e-3, dev.max(axis=0)


def fault_missions():
    """tests/test_fault_injection.py's corrupt-scan missions, as (scan, imu)
    steps: an empty scan, a scan with every 7th point NaN (through
    `from_velodyne`, which drops them) and two single-plane scans."""
    from lio_slam_tpu_torch.io import formats
    from lio_slam_tpu_torch.utils import se3

    seq = synthetic.make_sequence(n_scans=3, n_points=2048, seed=0)

    def scan(i, xyz=None):
        xyz = seq.scans[i][seq.scan_masks[i]] if xyz is None else xyz
        k = len(xyz)
        return formats.StandardScan(
            xyz=xyz, intensity=np.zeros(k, np.float32),
            ring=np.zeros(k, np.uint16), time=np.zeros(k, np.float32),
            stamp=float(seq.stamps[i]))

    def imu(i):
        inc = se3.pose6_between(t(seq.poses[i - 1]), t(seq.poses[i])).numpy()
        return {"acc": np.tile([0, 0, 9.81], (10, 1)).astype(np.float32),
                "gyr": np.tile(inc[:3] / 0.1, (10, 1)).astype(np.float32),
                "stamps": seq.stamps[i - 1] + np.arange(1, 11) * 0.01}

    nan = seq.scans[1][seq.scan_masks[1]].copy()
    nan[::7] = np.nan
    z = lambda k: np.zeros(k, np.float32)
    rs = np.random.RandomState(0)
    plane = []
    for i in range(2):
        xyz = np.stack([rs.uniform(-10, 10, 1500), rs.uniform(-10, 10, 1500),
                        rs.normal(0, 0.02, 1500) - 1.5], 1).astype(np.float32)
        plane.append((formats.StandardScan(
            xyz=xyz, intensity=z(1500), ring=np.zeros(1500, np.uint16),
            time=z(1500), stamp=0.1 * i), None))
    return {
        "empty": [(scan(0), None), (scan(1, np.zeros((0, 3), np.float32)),
                                    imu(1)), (scan(2), imu(2))],
        "nan": [(scan(0), None), (formats.from_velodyne(
            nan, z(len(nan)), np.zeros(len(nan), np.uint16), z(len(nan)),
            float(seq.stamps[1])), imu(1))],
        "plane": plane,
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty", "nan", "plane"])
def test_corrupt_scans_on_the_card(cuda, case, monkeypatch):
    """The fault-injection scans through `Runner(device="cuda")`: finite
    poses, the CPU port's degenerate flags, a launch a GN iteration, each
    launch as the plain version on its own arguments; then the kernel on
    the mission's map with the scan mask all false and with one point in
    ten valid, against the plain version."""
    from lio_slam_tpu_torch.config import RegistrationConfig, StaticConfig

    cfg = Config(static=StaticConfig(max_raw_points=2048, max_scan_points=2048,
                                     max_map_points=8192, max_keyframes=16,
                                     max_keyframe_points=1024, max_loop_queue=2,
                                     max_gps_queue=2, window_size=8,
                                     max_imu_window=32),
                 registration=RegistrationConfig(degeneracy_eig_thresh=10.0))
    steps = fault_missions()[case]
    kernel = fc.fused_ne_from_bucket_ids
    launched = []

    def checked(*a, **k):
        out = kernel(*a, **k)
        if a[0].is_cuda:
            launched.append(a)
            assert_ne_close_or_cancelling(out, a, k)
        return out

    monkeypatch.setattr(fc, "fused_ne_from_bucket_ids", checked)
    runner = Runner(cfg, device=cuda, loop_every=100)
    fc.KERNEL_LAUNCHES = 0
    res = [runner.process_scan(s, imu=i) for s, i in steps]
    assert fc.KERNEL_LAUNCHES == len(launched) == \
        sum(r.registration_iters for r in res) > 0
    cpu = Runner(cfg, device="cpu", loop_every=100)
    ref = [cpu.process_scan(s, imu=i) for s, i in steps]
    assert all(np.isfinite(r.pose).all() for r in res)
    assert [r.degenerate for r in res] == [r.degenerate for r in ref]
    if case == "plane":
        assert res[-1].degenerate

    table, hh, scan, mask, pose = launched[-1][:5]
    for keep in (torch.zeros_like(mask),
                 mask & (torch.arange(len(mask), device=cuda) % 10 == 0)):
        before = fc.KERNEL_LAUNCHES
        out = checked(table, hh, scan, keep, pose)
        assert fc.KERNEL_LAUNCHES == before + 1
        if not keep.any():
            assert int(out[2]) == 0 and float(out[0].abs().sum()) == 0.0


@pytest.mark.cuda
def test_graph_replay_matches_the_eager_replay(cuda):
    """`make_pipeline_replay(loop_every=4)` on the card, each scan two
    captured CUDA graphs, against `HostDrivenReplay` on the card over 10
    scans at tests/test_replay.py's config: poses, GN iterations and
    degenerate flags bit-equal, TransformFusion within 1e-6; the replay
    loop under `torch.cuda.set_sync_debug_mode("error")` but for the
    cadence calls; the kernel counted where it runs, at each replay of the
    graph that holds it, not at its capture; a second call reuses the
    graphs and repeats the poses."""
    from lio_slam_tpu_torch.config import (RegistrationConfig,
                                           StaticConfig)
    from lio_slam_tpu_torch.pipeline import replay

    cfg = Config(static=StaticConfig(max_raw_points=2048, max_scan_points=2048,
                                     max_map_points=8192, max_keyframes=16,
                                     max_keyframe_points=1024, max_loop_queue=2,
                                     max_gps_queue=2, window_size=8,
                                     max_imu_window=16),
                 registration=RegistrationConfig(degeneracy_eig_thresh=10.0))
    n_scans = 10
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=0)
    acc, gyr, dts, rel_t, imask = synthetic.make_imu_windows(
        seq, 16, samples_per_scan=8, gravity=cfg.imu.gravity)
    batch = replay.ReplayBatch(
        xyz=seq.scans, ptime=np.zeros((n_scans, 2048), np.float32),
        pmask=seq.scan_masks, ring=np.zeros((n_scans, 2048), np.int32),
        acc=acc, gyr=gyr, dts=dts, rel_t=rel_t, imask=imask, stamp=seq.stamps)
    hd = replay.HostDrivenReplay(cfg, loop_every=4, device=cuda)
    _, _, eager = hd.run(*hd.init(), hd.split(batch))

    run = replay.make_pipeline_replay(cfg, loop_every=4, device=cuda)
    staged = run.stage(batch)
    state, fes = run.init()
    R = cfg.registration.max_iterations
    fc.KERNEL_LAUNCHES = gn.KERNEL_LAUNCHES = gn.EIGH_LAUNCHES = 0
    ws.KERNEL_LAUNCHES = 0
    run.capture(state, fes, staged)
    assert run.capture_seconds is not None
    # the warm-up's two eager scans launch the kernel at every GN pass; the
    # capture only records graph (a)'s R launches
    assert fc.KERNEL_LAUNCHES == 2 * R
    assert run.program.graph_launches == (R, 0)
    # so does the GN step's kernel, the first pass with the eigensolve
    assert (gn.KERNEL_LAUNCHES, gn.EIGH_LAUNCHES) == (2 * R, 2)
    assert run.program.gn_graph_launches == ((R, 1), (0, 0))
    # and the masked keyframe save's window solve, two iterations a scan
    assert ws.KERNEL_LAUNCHES == 2 * 2
    assert run.program.ws_graph_launches == (2, 0)

    def quiet(fn):
        def wrapped(*a, **k):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return wrapped

    run.detector, run.full_correct = quiet(run.detector), quiet(run.full_correct)
    outs = []
    fc.KERNEL_LAUNCHES = gn.KERNEL_LAUNCHES = gn.EIGH_LAUNCHES = 0
    ws.KERNEL_LAUNCHES = 0
    for _ in range(2):
        state, fes = run.init()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs.append(run(state, fes, staged)[2])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    graph = outs[0]
    for name in ("poses", "iters", "degenerate"):
        assert torch.equal(getattr(graph, name), getattr(eager, name)), name
    torch.testing.assert_close(graph.fused_last, eager.fused_last, rtol=0,
                               atol=1e-6)
    assert torch.equal(outs[1].poses, graph.poses)
    # each replay of graph (a) launches the kernel R times; the cadence
    # calls' loop verifications (none here: no candidate) would add theirs
    assert fc.KERNEL_LAUNCHES == 2 * n_scans * R
    assert (gn.KERNEL_LAUNCHES, gn.EIGH_LAUNCHES) == (2 * n_scans * R,
                                                      2 * n_scans)
    assert ws.KERNEL_LAUNCHES == 2 * n_scans * 2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rebuild_grid", "rebuild_brute", "corner",
                                  "halo_xy", "halo_full"])
def test_graph_replay_at_every_config(cuda, mode):
    """The resident programs at the other configs the JAX programs run,
    captured on the card: the rebuild-mode map (the local map assembled
    and, with the grid backend, its grid built inside graph (a), the kernel
    at every GN pass; the brute-force k-NN's chunked top-k captured too)
    and the corner config (the surface path: a replay feeds no corner
    cloud); and the "xy" / "full" halo layouts, whose captured launches
    read the state grid's own counts buffer (the filled prefixes the
    in-graph insert leaves).  Against `HostDrivenReplay` on the card over 6
    scans at
    tests/test_replay.py's config: poses, GN iterations and degenerate
    flags bit-equal, no synchronization inside the replay, the kernel's
    launches those the graphs hold."""
    from lio_slam_tpu_torch.config import RegistrationConfig, StaticConfig
    from lio_slam_tpu_torch.pipeline import replay

    reg = dict(degeneracy_eig_thresh=10.0)
    if mode.startswith("rebuild"):
        reg.update(local_map_mode="rebuild", knn_backend=mode.split("_")[1])
    elif mode.startswith("halo"):
        halo = mode.split("_")[1]
        reg.update(grid_halo=halo, grid_max_per_cell={"xy": 72, "full": 128}[halo])
    else:
        reg.update(use_corner_features=True)
    cfg = Config(static=StaticConfig(max_raw_points=2048, max_scan_points=2048,
                                     max_map_points=8192, max_keyframes=16,
                                     max_keyframe_points=1024, max_loop_queue=2,
                                     max_gps_queue=2, window_size=8,
                                     max_imu_window=16),
                 registration=RegistrationConfig(**reg))
    n_scans = 6
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=0)
    acc, gyr, dts, rel_t, imask = synthetic.make_imu_windows(
        seq, 16, samples_per_scan=8, gravity=cfg.imu.gravity)
    batch = replay.ReplayBatch(
        xyz=seq.scans, ptime=np.zeros((n_scans, 2048), np.float32),
        pmask=seq.scan_masks, ring=np.zeros((n_scans, 2048), np.int32),
        acc=acc, gyr=gyr, dts=dts, rel_t=rel_t, imask=imask, stamp=seq.stamps)
    hd = replay.HostDrivenReplay(cfg, loop_every=3, device=cuda)
    _, _, eager = hd.run(*hd.init(), hd.split(batch))

    run = replay.make_pipeline_replay(cfg, loop_every=3, device=cuda)
    staged = run.stage(batch)
    run.capture(*run.init(), staged)
    R = cfg.registration.max_iterations
    fused = mode != "rebuild_brute"
    assert run.program.graph_launches == ((R if fused else 0), 0)

    def quiet(fn):
        def wrapped(*a, **k):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return wrapped

    run.detector, run.full_correct = quiet(run.detector), quiet(run.full_correct)
    fc.KERNEL_LAUNCHES = 0
    state, fes = run.init()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, graph = run(state, fes, staged)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for name in ("poses", "iters", "degenerate"):
        assert torch.equal(getattr(graph, name), getattr(eager, name)), name
    assert int(graph.iters.max()) >= 1
    assert fc.KERNEL_LAUNCHES == (n_scans * R if fused else 0)


@pytest.mark.cuda
def test_replay_scan_marks_on_the_shared_clock(cuda):
    """The span recorder on the card around two chunks of 4 scans of the
    captured carry replay: each `replay.scan` has device marks that resolve
    in order (start before end, each scan after the one before it) and lie
    after the scan's host start on the host's clock; the capture is one
    `replay.capture` span inside `capture_seconds`; the resident step's
    spans are recorded in the capture's two eager warm-up passes and not
    in the graph capture that follows them."""
    from lio_slam_tpu_torch.config import RegistrationConfig, StaticConfig
    from lio_slam_tpu_torch.pipeline import replay
    from lio_slam_tpu_torch.utils.profiling import TRACER

    cfg = Config(static=StaticConfig(max_raw_points=2048, max_scan_points=2048,
                                     max_map_points=8192, max_keyframes=16,
                                     max_keyframe_points=1024, max_loop_queue=2,
                                     max_gps_queue=2, window_size=8,
                                     max_imu_window=16),
                 registration=RegistrationConfig(degeneracy_eig_thresh=10.0))
    n_scans, L = 8, 4
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=0)
    acc, gyr, dts, rel_t, imask = synthetic.make_imu_windows(
        seq, 16, samples_per_scan=8, gravity=cfg.imu.gravity)
    batch = replay.ReplayBatch(
        xyz=seq.scans, ptime=np.zeros((n_scans, 2048), np.float32),
        pmask=seq.scan_masks, ring=np.zeros((n_scans, 2048), np.int32),
        acc=acc, gyr=gyr, dts=dts, rel_t=rel_t, imask=imask, stamp=seq.stamps)
    chunk = replay.make_pipeline_replay_carry(cfg, device=cuda)
    staged = chunk.replay.stage(batch)
    chunks = [replay.ReplayBatch(*(a[k:k + L] for a in staged))
              for k in range(0, n_scans, L)]
    TRACER.clear()
    TRACER.enable()
    try:
        state, fes = chunk.replay.init()
        chunk.replay.capture(state, fes, chunks[0])
        last = torch.zeros(6, device=cuda)
        for cb in chunks:
            state, fes, last, _ = chunk(state, fes, last, cb)
        spans = TRACER.read()
    finally:
        TRACER.disable()
        TRACER.clear()
    cap = [s for s in spans if s.name == "replay.capture"]
    assert len(cap) == 1
    assert 0 < cap[0].seconds <= chunk.replay.capture_seconds
    assert {s.name for s in spans} == {
        "replay.capture", "replay.chunk", "replay.scan", "mapping.register",
        "save.sc_descriptor", "save.window_solve", "save.map_insert"}
    step = [s for s in spans if s.name.startswith(("mapping.", "save."))]
    assert [s.name for s in step].count("mapping.register") == 2
    assert all(s.parent == cap[0].id for s in step
               if s.name == "mapping.register")
    assert all(cap[0].t0 <= s.t0 <= s.t1 <= cap[0].t1 for s in step)
    scans = [s for s in spans if s.name == "replay.scan"]
    assert [s.scan for s in scans] == list(range(L)) * 2
    for s in scans:
        assert s.t0 <= s.d0 < s.d1, s
    for a, b in zip(scans, scans[1:]):
        assert a.d1 <= b.d0, (a, b)
    assert all(s.d0 is None for s in spans if s.name != "replay.scan")
