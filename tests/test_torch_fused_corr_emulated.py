"""The CUDA kernel's own source (`lio_slam_tpu_torch/ops/csrc/fused_corr.cu`)
run on the CPU: compiled with g++ against `tests/cuda_emulator.h` (one
thread a CUDA thread, barriers for the warp and block primitives;
`tests/torch_port_cuda_emulator.py`) and held to the plain version, which
is what the wrapper runs on CPU tensors.  The card holds the compiled
kernel to the same contract (tests/test_torch_cuda.py, chip_smoke.py);
here the tests reach the kernel's control flow and arithmetic where there
is no card: the group's ranking and merge, the streamed stage of the
27-id instantiation (three chunks of 9 offsets), the duplicate and
out-of-range ids, the 4-byte copies, masked and non-finite points, the
block's warps, the deterministic two-level sum and the ticket.

The contract of `ROADMAP.md` queue 2: inliers exact, AtA / Atb within
rtol 2e-4 / atol 2e-3 and the weight sums within rtol 1e-4 of the plain
version, repeated launches bit-identical.  The emulator runs the blocks
one after another, so it cannot show what the card's scheduling would.
"""

import numpy as np
import pytest
import torch

import torch_port_cuda_emulator as E
from torch_port_helpers import planar_scene, streamed_stage_case, t
from lio_slam_tpu_torch.ops import fused_corr as fc
from lio_slam_tpu_torch.ops import voxel_grid as vg

KW = dict(nn_radius=1.0, plane_dist_thresh=0.2, robust_weight_floor=0.1)
POSE = np.array([0.02, -0.01, 0.3, 0.5, -0.2, 0.1], np.float32)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return E.build(tmp_path_factory.mktemp("emulated_kernel"))


def assert_ne_close(out, ref):
    assert int(out[2]) == int(ref[2])
    for i in (0, 1):
        torch.testing.assert_close(out[i], ref[i], rtol=2e-4, atol=2e-3)
    for i in (3, 4):
        torch.testing.assert_close(out[i], ref[i], rtol=1e-4, atol=1e-4)


def layout_scene(halo, cap, n_scan=260, seed=6):
    map_pts, scan = planar_scene(seed, n_map=4096, n_scan=n_scan)
    grid = vg.build_grid(t(map_pts), torch.ones(len(map_pts), dtype=torch.bool),
                         1.0, 4096, cap, halo=halo)
    scan = t(scan)
    mask = torch.ones(len(scan), dtype=torch.bool)
    mask[3::11] = False
    pose = t(POSE)
    return grid.table, fc._bucket_ids_at(grid, scan, pose, halo), scan, mask, pose


@pytest.mark.parametrize("cap", [24, 22])
@pytest.mark.parametrize("case", ["tie", "last_chunk", "duplicates"])
def test_streamed_stage_cases(lib, case, cap):
    """The 27-id instantiation on `streamed_stage_case`'s inputs: a tie
    straddling a chunk boundary, the five nearest in the last chunk, many
    duplicate and out-of-range ids; at a cap that is a multiple of 4 and
    one that is not."""
    args = streamed_stage_case(case, cap, n_points=200)
    ref = fc.fused_ne_from_bucket_ids_ref(*args, **KW)
    assert int(ref[2]) > 100
    assert_ne_close(E.fused_ne_emulated(lib, *args, **KW), ref)


@pytest.mark.parametrize("halo,cap", [("none", 24), ("none", 22), ("none", 5),
                                      ("none", 96), ("z", 24), ("z", 10),
                                      ("xy", 72), ("full", 128)])
def test_every_instantiation_matches_the_plain_version(lib, halo, cap):
    """Each instantiation (27, 9, 3, 1 ids a point) on grids built by
    `voxel_grid.build_grid` over a planar scene, every 11th point masked:
    at none/5 a chunk's 45 rows move a lane's rows from one chunk to the
    next, at none/96 the stages are so wide that a block holds 4 warps."""
    args = layout_scene(halo, cap)
    ref = fc.fused_ne_from_bucket_ids_ref(*args, **KW)
    assert int(ref[2]) > 50
    assert_ne_close(E.fused_ne_emulated(lib, *args, **KW), ref)


@pytest.mark.parametrize("O,C,warps", [(27, 24, 16), (9, 24, 16), (3, 72, 16),
                                       (1, 128, 16), (27, 48, 8), (27, 96, 4),
                                       (9, 96, 4)])
def test_block_warps(lib, O, C, warps):
    """The launcher's block: 16 warps wherever a point's stage fits 64 a
    block, as at 27 ids since the rows stream through a 9-offset stage;
    fewer where the rows are wider."""
    assert lib.lio_fused_corr_block_warps(O, C) == warps


@pytest.mark.parametrize("halo", ["none", "z"])
def test_repeated_launches_are_bit_identical_and_reset_the_ticket(lib, halo):
    args = layout_scene(halo, 24)
    scratch = torch.zeros(lib.lio_fused_corr_scratch_floats())
    first = E.fused_ne_emulated(lib, *args, **KW, scratch=scratch)
    assert float(scratch[0]) == 0.0          # the last block reset the ticket
    again = E.fused_ne_emulated(lib, *args, **KW, scratch=scratch)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("halo", ["none", "z"])
def test_non_finite_and_masked_points_contribute_nothing(lib, halo):
    table, hh, scan, mask, pose = layout_scene(halo, 24)
    scan = scan.clone()
    scan[5] = float("nan")
    scan[40, 1] = float("inf")
    out = E.fused_ne_emulated(lib, table, hh, scan, mask, pose, **KW)
    assert bool(torch.isfinite(out[0]).all())
    assert_ne_close(out, fc.fused_ne_from_bucket_ids_ref(table, hh, scan, mask,
                                                         pose, **KW))
    none = E.fused_ne_emulated(lib, table, hh, scan, torch.zeros_like(mask),
                               pose, **KW)
    assert int(none[2]) == 0 and float(none[0].abs().sum()) == 0.0


def test_launcher_refuses_other_offset_counts(lib):
    table, hh, scan, mask, pose = layout_scene("z", 24)
    for ids in (hh[:2], torch.cat([hh, hh[:1]])):
        with pytest.raises(RuntimeError, match="refused"):
            E.fused_ne_emulated(lib, table, ids, scan, mask, pose, **KW)


# ---- the wide-row design (1 and 3 ids a point): the filled prefix ----

def wide_scene(halo, cap, case, n_scan=260, seed=6):
    """A grid from `voxel_grid.build_grid` over a planar scene and a scan at
    POSE, every 11th point masked, with rows partly filled ("partial"),
    most full after ring overwrites (a dense map inserted in chunks:
    "ring"), or mostly empty with points that see fewer than five filled
    slots ("sparse").  Returns (table, hh, scan, mask, pose, counts)."""
    n_map = {"partial": 4096, "ring": 32768, "sparse": 512}[case]
    map_pts, scan = planar_scene(seed, n_map=n_map, n_scan=n_scan)
    grid = vg.build_grid(t(map_pts), torch.ones(len(map_pts), dtype=torch.bool),
                         1.0, 4096, cap, halo=halo, chunk=4096)
    scan = t(scan)
    mask = torch.ones(len(scan), dtype=torch.bool)
    mask[3::11] = False
    pose = t(POSE)
    hh = fc._bucket_ids_at(grid, scan, pose, halo)
    return grid.table, hh, scan, mask, pose, grid.counts


def filled_slots(hh, counts):
    """(O, N) filled slots of each bucket a point reads (0 off the table)."""
    T = counts.shape[0]
    inside = (hh >= 0) & (hh < T)
    return torch.where(inside, counts[hh.clamp(0, T - 1).long()],
                       torch.zeros_like(hh))


def assert_counts_bit_equal(lib, args, counts, ref):
    """The launch with `counts` against the plain version, against the
    launch without (whole rows) bit for bit, and against itself again, the
    ticket back at 0."""
    scratch = torch.zeros(lib.lio_fused_corr_scratch_floats())
    out = E.fused_ne_emulated(lib, *args, **KW, counts=counts, scratch=scratch)
    assert float(scratch[0]) == 0.0
    assert_ne_close(out, ref)
    whole = E.fused_ne_emulated(lib, *args, **KW)
    assert all(torch.equal(a, b) for a, b in zip(out, whole))
    again = E.fused_ne_emulated(lib, *args, **KW, counts=counts, scratch=scratch)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    return out


@pytest.mark.parametrize("halo,cap,case", [
    ("full", 64, "partial"), ("full", 128, "partial"), ("xy", 72, "partial"),
    ("full", 64, "ring"), ("xy", 72, "ring"), ("full", 128, "sparse"),
    ("xy", 72, "sparse"), ("xy", 70, "partial"), ("full", 66, "ring")])
def test_wide_rows_rank_only_the_filled_prefix(lib, halo, cap, case):
    """At 1 and 3 ids a point the kernel copies and ranks only each row's
    filled prefix (`counts`): held to the plain version, which ranks every
    slot, and bit-equal to the same launch on whole rows.  The prefixes
    cover rows partly filled (most of them 12 x counts bytes that are no
    multiple of 16), full after ring overwrites, empty, and points that see
    fewer than five filled slots; caps 70 and 66 take the 4-byte copies."""
    table, hh, scan, mask, pose, counts = wide_scene(halo, cap, case)
    filled = filled_slots(hh, counts)
    assert int(((filled * 12) % 16 != 0).sum()) > 0
    if case == "ring":
        assert int((counts == cap).sum()) > 500
    if case == "sparse":
        assert int((counts == 0).sum()) > 1000
        assert int((filled.sum(0) < 5).sum()) > 20
    args = (table, hh, scan, mask, pose)
    ref = fc.fused_ne_from_bucket_ids_ref(*args, **KW)
    assert int(ref[2]) > (0 if case == "sparse" else 50)
    assert_counts_bit_equal(lib, args, counts, ref)


@pytest.mark.parametrize("halo,cap", [("full", 128), ("xy", 72)])
def test_wide_rows_skip_duplicate_and_out_of_range_ids(lib, halo, cap):
    """Ids repeated within a point (at 3 ids), below 0 and at or past the
    table's end: such a bucket is neither copied nor ranked, with `counts`
    or without."""
    table, hh, scan, mask, pose, counts = wide_scene(halo, cap, "partial")
    T = table.shape[0]
    hh = hh.clone()
    hh[-1, 0::5] = -1
    hh[-1, 1::7] = T
    hh[0, 2::13] = T + 7
    if hh.shape[0] == 3:
        hh[1, 0::3] = hh[0, 0::3]
        hh[2, 1::4] = hh[1, 1::4]
    args = (table, hh, scan, mask, pose)
    ref = fc.fused_ne_from_bucket_ids_ref(*args, **KW)
    assert int(ref[2]) > 30
    assert_counts_bit_equal(lib, args, counts, ref)


@pytest.mark.parametrize("halo,cap", [("full", 128), ("xy", 72)])
def test_wide_rows_non_finite_and_masked_points(lib, halo, cap):
    """With `counts`, a non-finite point or a masked one adds nothing."""
    table, hh, scan, mask, pose, counts = wide_scene(halo, cap, "partial")
    scan = scan.clone()
    scan[5] = float("nan")
    scan[40, 1] = float("inf")
    args = (table, hh, scan, mask, pose)
    out = assert_counts_bit_equal(lib, args, counts,
                                  fc.fused_ne_from_bucket_ids_ref(*args, **KW))
    assert bool(torch.isfinite(out[0]).all())
    none = E.fused_ne_emulated(lib, table, hh, scan, torch.zeros_like(mask),
                               pose, **KW, counts=counts)
    assert int(none[2]) == 0 and float(none[0].abs().sum()) == 0.0


@pytest.mark.parametrize("halo,cap", [("full", 128), ("xy", 72), ("z", 24),
                                      ("none", 24)])
def test_floor_runs_the_fixed_chain(lib, halo, cap):
    """The launch floor (`lio_fused_corr_floor`): the same grid and block,
    the ids loaded and checked, nothing staged or ranked; its inlier word
    counts the unmasked points with a bucket to read, its ticket returns to
    0."""
    table, hh, scan, mask, pose = layout_scene(halo, cap)
    T = table.shape[0]
    reads = ((hh >= 0) & (hh < T)).any(0) & mask
    scratch = torch.zeros(lib.lio_fused_corr_scratch_floats())
    out = E.fused_ne_emulated(lib, table, hh, scan, mask, pose, **KW,
                              scratch=scratch, floor=True)
    assert int(out[2]) == int(reads.sum()) > 0
    assert float(scratch[0]) == 0.0


def test_wrapper_checks_counts():
    """The launch's argument checks refuse a `counts` that is not the
    grid's (T,) int32 buffer on the table's device, contiguous."""
    table, hh, scan, mask, pose, counts = wide_scene("full", 64, "partial")
    args = (table, hh, scan, mask, pose)
    fc._check_cuda_inputs(*args, counts)
    fc._check_cuda_inputs(*args, None)
    with pytest.raises(TypeError, match="int32"):
        fc._check_cuda_inputs(*args, counts.long())
    with pytest.raises(ValueError, match="one a bucket"):
        fc._check_cuda_inputs(*args, counts[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        fc._check_cuda_inputs(*args, torch.stack([counts, counts], 1)[:, 0])
    # on the CPU the wrapper runs the plain version, which ranks every slot
    got = fc.fused_ne_from_bucket_ids(*args, **KW, counts=counts)
    want = fc.fused_ne_from_bucket_ids_ref(*args, **KW)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_gn_loop_passes_the_grids_own_counts(monkeypatch):
    """`registration._maybe_fused`'s held-id pass hands the kernel the
    grid's own counts buffer (a captured graph must read the one the
    in-graph insert updates, not a copy)."""
    from lio_slam_tpu_torch.config import RegistrationConfig
    from lio_slam_tpu_torch.ops import registration as reg

    table, hh, scan, mask, pose, counts = wide_scene("xy", 72, "partial")
    grid = vg.HashGrid(table=table, counts=counts,
                       cell_size=torch.full((), 1.0))
    seen = []
    monkeypatch.setattr(fc, "fused_ne_from_bucket_ids",
                        lambda *a, **k: seen.append(k["counts"]))
    cfg = RegistrationConfig(grid_halo="xy", corr_refresh_every=2)
    bucket_fn, from_ids_fn, refresh = reg._maybe_fused(scan, mask, grid, cfg)
    from_ids_fn(bucket_fn(pose), pose)
    assert refresh == 2 and seen[0] is grid.counts
