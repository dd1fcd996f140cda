"""The grid's gather layouts in the port against the JAX package: halo "xy"
and "full" beside "z" and "none", the fused pass at every layout, the
cell-sorted scan and the hash downsample.

- Grid: bucket ids, tables and counts bit-equal at "xy" and "full" (batch
  build, chunked build, incremental insert, masked points, an overflowing
  bucket), `query_knn` and `gather_candidates` as JAX's; the in-radius
  guarantees of tests/test_voxel_grid.py.
- The plain version of the kernel at ("z", 24), ("xy", 72), ("full", 64)
  and ("none", 24), held to the Pallas kernel in interpret mode and to the
  unfused JAX path with the kernel contract (inliers exact, AtA / Atb
  within rtol 2e-4 / atol 2e-3, the Σ terms within rtol 1e-4), and on
  bucket ids held from another pose at "full".
- `registration._cell_sorted`: the order bit-equal, ties and masked points
  included.
- `pointcloud.hash_downsample`: bit-equal to JAX's CPU result (the last
  point of a slot wins), and the quality cases of tests/test_pointcloud.py.
- A 5-scan mission a layout through both Runners, and the resident step
  with the hash downsample and the sorted scan against the eager one.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from torch_port_helpers import n, planar_scene, t
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.ops import fused_corr as jfc
from lio_slam_tpu.ops import knn as jknn
from lio_slam_tpu.ops import registration as jreg
from lio_slam_tpu.ops import voxel_grid as jvg
from lio_slam_tpu.utils import pointcloud as jpc
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.ops import fused_corr as tfc
from lio_slam_tpu_torch.ops import preintegration as pre
from lio_slam_tpu_torch.ops import registration as treg
from lio_slam_tpu_torch.ops import voxel_grid as tvg
from lio_slam_tpu_torch.pipeline import imu_frontend as fe
from lio_slam_tpu_torch.pipeline import replay
from lio_slam_tpu_torch.pipeline import synthetic_mission as sm
from lio_slam_tpu_torch.pipeline.runner import Runner
from lio_slam_tpu_torch.utils import pointcloud as tpc
from lio_slam_tpu_torch.utils import se3 as tse3
from test_torch_fused_corr import KW, POSE, assert_ne_close
from test_torch_pipeline_replay import eviction_config
from test_torch_replay import numpy_batch
from test_torch_voxel_grid import T_SIZE, scene

NEW_HALOS = ("xy", "full")
# the layouts of tests/test_fused_corr.py:34, each with its bucket cap
LAYOUTS = (("z", 24), ("xy", 72), ("full", 64), ("none", 24))


def both_grids(pts, mask, halo, cap, table=T_SIZE, chunk=262144):
    return (jvg.build_grid(jnp.asarray(pts), jnp.asarray(mask), 1.0, table,
                           cap, halo=halo, chunk=chunk),
            tvg.build_grid(t(pts), t(mask), 1.0, table, cap, halo=halo,
                           chunk=chunk))


def assert_grids_equal(a, b):
    np.testing.assert_array_equal(n(b.table), n(a.table))
    np.testing.assert_array_equal(n(b.counts), n(a.counts))


# --------------------------------------------------------------------------
# the grid
# --------------------------------------------------------------------------

@pytest.mark.parametrize("halo", NEW_HALOS + ("none",))
def test_bucket_ids_bit_identical(halo):
    pts, _ = scene()
    for T in (T_SIZE, 1000):
        _, hh = jfc.gather_planar(jvg.empty_grid(1.0, T, 8), jnp.asarray(pts),
                                  halo)
        got = tvg.bucket_ids(t(pts), tvg.empty_grid(1.0, T, 8).cell_size, T,
                             halo)
        np.testing.assert_array_equal(n(got), np.asarray(hh))
        assert got.shape[0] == {"none": 27, "xy": 3, "full": 1}[halo]


@pytest.mark.parametrize("chunk", [262144, 500])
@pytest.mark.parametrize("halo", NEW_HALOS)
def test_build_then_insert_identical(halo, chunk):
    """Chunks count points, whatever the rows a point (27 at "full"); the
    40-point cell overflows its bucket and the ring overwrites as JAX's."""
    pts, mask = scene(1)
    more, mmask = scene(2)
    ga, gb = both_grids(pts, mask, halo, 8, chunk=chunk)
    assert_grids_equal(ga, gb)
    assert n(gb.counts).max() == 8
    ga = jvg.insert_points(ga, jnp.asarray(more), jnp.asarray(mmask), halo=halo)
    gb = tvg.insert_points(gb, t(more), t(mmask), halo=halo)
    assert_grids_equal(ga, gb)


@pytest.mark.parametrize("halo,cap", [("xy", 24), ("full", 64)])
def test_query_knn_matches(halo, cap):
    pts, mask = scene(3)
    ga, gb = both_grids(pts, mask, halo, cap)
    rs = np.random.RandomState(4)
    q = (pts[rs.permutation(len(pts))[:300]]
         + rs.randn(300, 3).astype(np.float32) * 0.1).astype(np.float32)
    qmask = rs.uniform(size=300) > 0.1
    ra = jvg.query_knn(ga, jnp.asarray(q), jnp.asarray(qmask), k=5, halo=halo)
    rb = tvg.query_knn(gb, t(q), t(qmask), k=5, halo=halo)
    v = n(ra.valid)
    np.testing.assert_array_equal(n(rb.valid), v)
    assert v.sum() > 100
    np.testing.assert_allclose(n(rb.dist2)[v], n(ra.dist2)[v], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(n(rb.neighbors)[v], n(ra.neighbors)[v])


@pytest.mark.parametrize("halo,seed", [("xy", 5), ("full", 6)])
def test_layout_matches_bruteforce_within_radius(halo, seed):
    """tests/test_voxel_grid.py's guarantee, on its scenes: exact for
    in-radius neighbours, as the 27-cell layout is."""
    rs = np.random.RandomState(seed)
    ref = rs.randn(2000, 3).astype(np.float32) * 5
    q = ref[rs.choice(2000, 300, replace=False)] + \
        rs.randn(300, 3).astype(np.float32) * 0.1
    grid = tvg.build_grid(t(ref), torch.ones(2000, dtype=torch.bool), 1.0,
                          4096, 160, halo=halo)
    got = tvg.query_knn(grid, t(q), torch.ones(300, dtype=torch.bool), k=5,
                        halo=halo)
    brute = jknn.knn(jnp.asarray(q), jnp.ones(300, bool), jnp.asarray(ref),
                     jnp.ones(2000, bool), k=5)
    in_radius = np.asarray(brute.dist2[:, 4]) < 1.0
    assert in_radius.sum() > 20
    np.testing.assert_allclose(np.sort(n(got.dist2), 1)[in_radius],
                               np.sort(np.asarray(brute.dist2), 1)[in_radius],
                               rtol=1e-3, atol=1e-4)


def test_full_incremental_insert_matches_batch_build():
    rs = np.random.RandomState(7)
    a = rs.randn(300, 3).astype(np.float32) * 4
    b = rs.randn(300, 3).astype(np.float32) * 4 + 2.0
    ones = np.ones(300, bool)
    ja = jvg.insert_points(jvg.insert_points(
        jvg.empty_grid(1.0, 2048, 160), jnp.asarray(a), jnp.asarray(ones),
        halo="full"), jnp.asarray(b), jnp.asarray(ones), halo="full")
    inc = tvg.insert_points(tvg.insert_points(
        tvg.empty_grid(1.0, 2048, 160), t(a), t(ones), halo="full"),
        t(b), t(ones), halo="full")
    assert_grids_equal(ja, inc)
    batch = tvg.build_grid(t(np.concatenate([a, b])),
                           torch.ones(600, dtype=torch.bool), 1.0, 2048, 160,
                           halo="full")
    q, qm = t(a[:64]), torch.ones(64, dtype=torch.bool)
    np.testing.assert_allclose(
        np.sort(n(tvg.query_knn(inc, q, qm, k=5, halo="full").dist2), 1),
        np.sort(n(tvg.query_knn(batch, q, qm, k=5, halo="full").dist2), 1),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("halo", NEW_HALOS)
def test_masked_points_ignored(halo):
    ref = np.concatenate([np.zeros((4, 3)), np.full((4, 3), 0.1)]).astype(np.float32)
    rm = np.array([True] * 4 + [False] * 4)
    ga, gb = both_grids(ref, rm, halo, 64, table=512)
    assert_grids_equal(ga, gb)
    got = tvg.query_knn(gb, torch.zeros((1, 3)), torch.ones(1, dtype=torch.bool),
                        k=5, halo=halo)
    assert int(got.valid.sum()) == 4


def test_gather_candidates_matches_jax():
    rs = np.random.RandomState(8)
    ref = rs.randn(400, 3).astype(np.float32) * 3
    ga, gb = both_grids(ref, np.ones(400, bool), "full", 64, table=1024)
    q = ref[:32] + rs.randn(32, 3).astype(np.float32) * 0.05
    got = tvg.gather_candidates(gb, t(q))
    assert got.shape == (3 * 64, 32)
    np.testing.assert_array_equal(n(got),
                                  np.asarray(jvg.gather_candidates(ga, jnp.asarray(q))))
    cand = n(tvg.gather_candidates(gb, t(ref[:32])))
    d2 = ((cand[:64] - ref[:32, 0]) ** 2 + (cand[64:128] - ref[:32, 1]) ** 2
          + (cand[128:] - ref[:32, 2]) ** 2)
    assert np.all(d2.min(axis=0) < 1e-8)


# --------------------------------------------------------------------------
# the fused pass at every layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("halo,cap", LAYOUTS)
def test_plain_kernel_matches_jax_at_every_layout(halo, cap):
    map_pts, scan = planar_scene(0)
    mask = np.ones(len(scan), bool)
    ga, gb = both_grids(map_pts, np.ones(len(map_pts), bool), halo, cap)
    pose = jnp.asarray(POSE)
    port = tfc.fused_normal_equations(gb, t(scan), t(mask), t(POSE), halo=halo,
                                      **KW)
    kernel = jfc.fused_normal_equations(ga, jnp.asarray(scan), jnp.asarray(mask),
                                        pose, halo=halo, tile=128,
                                        interpret=True, **KW)
    assert_ne_close(port, kernel)
    jcfg = jax_config.RegistrationConfig(grid_halo=halo, grid_max_per_cell=cap)
    corr = jreg.find_correspondences(jnp.asarray(scan), jnp.asarray(mask),
                                     None, None, pose, jcfg, grid=ga)
    AtA, Atb = jreg._normal_equations(jnp.asarray(scan), corr, pose)
    assert_ne_close(port, (AtA, Atb, int(jnp.sum(corr.valid)),
                           float(jnp.sum(corr.weight)),
                           float(jnp.sum(corr.weight * jnp.abs(corr.residual)))))
    assert int(port[2]) > 100


def test_held_bucket_ids_at_full():
    """Bucket ids from one pose, the pass at another (corr_refresh_every >
    1 holds them): the JAX kernel on its candidate block from the first
    pose against the port on the held ids."""
    map_pts, scan = planar_scene(2)
    mask = np.ones(len(scan), bool)
    mask[::5] = False
    ga, gb = both_grids(map_pts, np.ones(len(map_pts), bool), "full", 64)
    held = POSE + np.array([0.0, 0.0, 0.004, 0.03, -0.02, 0.01], np.float32)
    R, tr = tse3.pose6_to_Rt(t(held))
    scan_w = tse3.transform_points(R, tr, t(scan))
    hh = tvg.bucket_ids(scan_w, gb.cell_size, T_SIZE, "full")
    cand, hh_j = jfc.gather_planar(ga, jnp.asarray(n(scan_w)), "full")
    np.testing.assert_array_equal(n(hh), np.asarray(hh_j))
    np.testing.assert_array_equal(n(tvg.gather_candidates(gb, scan_w)),
                                  np.asarray(cand))
    port = tfc.fused_ne_from_bucket_ids(gb.table, hh, t(scan), t(mask),
                                        t(POSE), **KW)
    ref = jfc.fused_ne_from_candidates(cand, hh_j, jnp.asarray(scan),
                                       jnp.asarray(mask), jnp.asarray(POSE),
                                       halo="full", tile=128, interpret=True,
                                       **KW)
    assert_ne_close(port, ref)
    assert int(port[2]) > 50


# --------------------------------------------------------------------------
# the cell-sorted scan and the hash downsample
# --------------------------------------------------------------------------

def test_cell_sorted_order_bit_equal():
    """Many points share a cell (ties keep their order), cells past the
    10-bit clip, masked points last in their own order."""
    rs = np.random.RandomState(9)
    scan = np.concatenate([
        rs.uniform(-6, 6, (600, 3)),
        np.repeat(rs.uniform(-2, 2, (20, 3)), 8, axis=0),     # exact ties
        rs.uniform(-900, 900, (40, 3))]).astype(np.float32)    # clipped cells
    scan = scan[rs.permutation(len(scan))]
    mask = rs.uniform(size=len(scan)) > 0.2
    ja, jm = jreg._cell_sorted(jnp.asarray(scan), jnp.asarray(mask), 1.0)
    pa, pm = treg._cell_sorted(t(scan), t(mask), 1.0)
    np.testing.assert_array_equal(n(pa), np.asarray(ja))
    np.testing.assert_array_equal(n(pm), np.asarray(jm))
    assert not n(pm)[int(mask.sum()):].any()


def test_hash_downsample_bit_equal():
    rs = np.random.RandomState(10)
    xyz = np.concatenate([rs.randn(3000, 3) * 8, rs.randn(500, 3) * 0.3]
                         ).astype(np.float32)
    for cap, leaf in ((4096, 0.4), (512, 0.8)):       # 512: slots collide
        mask = rs.uniform(size=len(xyz)) > 0.1
        ja = jpc.hash_downsample(jpc.Cloud(xyz=jnp.asarray(xyz),
                                           mask=jnp.asarray(mask)), leaf, cap)
        pb = tpc.hash_downsample(tpc.make_cloud(t(xyz), t(mask)), leaf, cap)
        np.testing.assert_array_equal(n(pb.mask), np.asarray(ja.mask))
        np.testing.assert_array_equal(n(pb.xyz), np.asarray(ja.xyz))
        assert int(pb.count()) > 0.3 * cap


def test_hash_downsample_quality():
    """tests/test_pointcloud.py's two cases: bounded collision loss, real
    input points only; masked points ignored."""
    rs = np.random.RandomState(5)
    xyz = rs.randn(5000, 3).astype(np.float32) * 10
    c = tpc.pad_cloud(xyz, 8192)
    exact = tpc.voxel_downsample(c, 0.8, 8192)
    fast = tpc.hash_downsample(c, 0.8, 8192)
    assert int(fast.count()) > 0.6 * int(exact.count())
    kept = n(fast.xyz)[n(fast.mask)]
    d = np.abs(kept[:, None, :] - xyz[None, :, :]).sum(-1).min(1)
    assert d.max() == 0.0
    xyz = torch.cat([torch.zeros((4, 3)), torch.full((4, 3), 7.0)])
    mask = torch.tensor([True] * 4 + [False] * 4)
    out = tpc.hash_downsample(tpc.Cloud(xyz=xyz, mask=mask), 0.5, 16)
    assert (n(out.xyz)[n(out.mask)] == 0).all() and int(out.count()) == 1


# --------------------------------------------------------------------------
# missions
# --------------------------------------------------------------------------

LAYOUT_FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "lio_slam_tpu_torch", "fixtures",
    "layout_missions_jax.npz")


def imu_state_of(ref, i):
    """The JAX front-end's state at the start of scan i of a fixture."""
    get = lambda k: t(ref[f"imu_{k}"][i])
    return fe.ImuFrontendState(
        nav=pre.NavState(R=get("R"), p=get("p"), v=get("v")),
        bias_gyr=get("bias_gyr"), bias_acc=get("bias_acc"), cov=get("cov"),
        initialized=get("initialized"), failure=get("failure"))


@pytest.mark.parametrize("name", [x[0] for x in sm.LAYOUT_MISSIONS])
def test_layout_mission_against_the_jax_runner(name):
    """5 scans of 2048 points at `small_config` widths, each scan of the
    port starting from the JAX front-end's state, against the JAX Runner's
    run of the same scans (`layout_missions_jax.npz`, keys `small_<name>_`:
    recorded by `torch_port_make_fixture.py layouts`, since the JAX Runner
    compiles for some 20 s a configuration): the same keyframes and GN
    iterations, poses within 1e-4 m, the grid's counts equal."""
    fixture = np.load(LAYOUT_FIXTURE)
    ref = {k[len(f"small_{name}_"):]: fixture[k] for k in fixture.files
           if k.startswith(f"small_{name}_")}
    seq = synthetic.make_sequence(n_scans=len(ref["poses"]), n_points=2048,
                                  seed=0)
    cfg = H.small_layout_config(name)
    scans, imus = sm.synthetic_inputs(seq, cfg)
    runner = Runner(cfg, device="cpu")
    results = []
    for i in range(len(scans)):
        runner.imu_state = imu_state_of(ref, i)
        results.append(runner.process_scan(scans[i], imu=imus[i]))
    H.assert_poses_match([r.pose for r in results], ref["poses"], atol_m=1e-4)
    assert [r.registration_iters for r in results] == \
        ref["registration_iters"].tolist()
    assert [r.is_keyframe for r in results] == ref["is_keyframe"].tolist()
    assert int(runner.state.store.count) == int(ref["keyframes"])
    np.testing.assert_array_equal(n(runner.state.map_grid.counts),
                                  ref["grid_counts"])
    assert ref["registration_iters"].sum() > 5


def test_resident_step_with_hash_and_sort_matches_the_eager_step():
    """`make_lio_step(resident=True)` with the hash downsample and the
    cell-sorted scan: bit-equal to the eager step over scans that cross
    evictions, and no host read after the first scan."""
    n_scans = 6
    base = eviction_config()
    cfg = dataclasses.replace(base, registration=dataclasses.replace(
        base.registration, sort_scan_by_cell=True, scan_downsample="hash"))
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=0)
    batch = numpy_batch(seq, cfg, n_scans)
    hd = replay.HostDrivenReplay(cfg, loop_every=0, device="cpu")
    state_e, _, eager = hd.run(*hd.init(), hd.split(batch))

    run = replay.make_pipeline_replay(cfg, loop_every=0, device="cpu")
    prog = run.program
    state, fes = run.init()
    staged = run.stage(batch)
    prog.load(state, fes, torch.zeros(6), staged)
    outs = prog.empty_outputs(n_scans)
    prog.finish_scan(prog.map_scan(staged, 0), outs, 0)
    with H.HostReadGuard():
        for i in range(1, n_scans):
            prog.finish_scan(prog.map_scan(staged, i), outs, i)
    assert int(prog.state.evict_count) >= 1
    for key in ("poses", "iters", "degenerate"):
        assert torch.equal(getattr(outs, key), getattr(eager, key)), key
    assert torch.equal(prog.state.map_grid.table, state_e.map_grid.table)
    assert int(n(eager.iters).sum()) > n_scans
