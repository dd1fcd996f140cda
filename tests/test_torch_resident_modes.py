"""The resident step and the device-resident replay programs
(`make_pipeline_replay`, `make_pipeline_replay_carry`, `ChunkedReplay` of
`pipeline/replay.py`) at the configs the JAX package's scan programs run
beside the incremental surface path: the rebuild-mode map (the local map
assembled from the nearby keyframes and registered through `register`,
with either k-NN backend) and the corner config (which a replay, feeding
no corner cloud, runs on the surface path, as the JAX step does).

On the CPU the resident step runs eagerly; on the card each scan is a
captured CUDA graph (tests/test_torch_cuda.py, chip_smoke.py phase 21).

- The resident step at `local_map_mode="rebuild"` against the eager one
  (`HostDrivenReplay`) over scans that cross evictions and the
  30-iteration cap: poses, iterations, degenerate flags and every leaf of
  the final state bit-equal, every scan after the first under
  `HostReadGuard` (no host read, no host data sent to the device).
- The rebuild-mode programs against the JAX monolith on the same numpy
  batch, read from `fixtures/pipeline_replay_jax.npz` (keys
  `small_rebuild_`, recorded by `torch_port_make_fixture.py rebuild`, so
  no JAX program compiles here): poses within 0.02 m and
  0.1 deg, degenerate flags equal, GN iterations within 1 a scan free
  running and with the JAX front-end's state carried into each scan.
- The cadence correction at rebuild mode: a loop consumed, the full
  correction at the cadence scan, and the scans after it registered
  against a local map assembled from the corrected store, bit-equal
  between the resident program and `HostDrivenReplay`.
- The corner config through the programs gives the surface config's
  outputs bit for bit; a corner cloud handed to the resident step raises.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import torch_port_helpers as H
from torch_port_helpers import n
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.pipeline import lio
from lio_slam_tpu_torch.pipeline import replay
from test_torch_pipeline_replay import (assert_trees_equal,
                                        dense_keyframes_config, leaves)
from test_torch_replay import numpy_batch

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "lio_slam_tpu_torch", "fixtures",
    "pipeline_replay_jax.npz")
MAX_DEV_M = 0.02                  # the mapping limits of chip_smoke.py
MAX_DEV_RAD = np.radians(0.1)
MAX_ITER_DIFF = 1


def rebuild(cfg, knn_backend="grid", **registration):
    return dataclasses.replace(cfg, registration=dataclasses.replace(
        cfg.registration, local_map_mode="rebuild", knn_backend=knn_backend,
        **registration))


def with_corners(cfg):
    return dataclasses.replace(cfg, registration=dataclasses.replace(
        cfg.registration, use_corner_features=True))


def small_batch(cfg, n_scans, seed=0):
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=seed)
    return numpy_batch(seq, cfg, n_scans)


def reference():
    fixture = np.load(FIXTURE)
    pre = "small_rebuild_"
    return {k[len(pre):]: fixture[k] for k in fixture.files
            if k.startswith(pre)}


def assert_near_reference(out, ref, carried_iters=None):
    """Part of the JAX monolith's limits: poses, degenerate flags, GN
    iterations within MAX_ITER_DIFF a scan (free running, and carried
    where given)."""
    poses = n(out.poses)
    assert poses.shape == ref["poses"].shape and np.isfinite(poses).all()
    assert np.abs(poses[:, 3:] - ref["poses"][:, 3:]).max() <= MAX_DEV_M
    assert np.abs(poses[:, :3] - ref["poses"][:, :3]).max() <= MAX_DEV_RAD
    np.testing.assert_array_equal(n(out.degenerate), ref["degenerate"])
    for iters in (n(out.iters), carried_iters):
        if iters is not None:
            d = np.abs(iters.astype(int) - ref["registration_iters"])
            assert d.max() <= MAX_ITER_DIFF, d


def eviction_config(knn_backend):
    """A 2-keyframe store on the rebuild-mode map, a keyframe every 0.1 m
    (about every scan): evictions from the third scan on.  The scan holds
    1024 points and the local map 2048, so the brute-force k-NN stays
    cheap on the CPU."""
    cfg = rebuild(dense_keyframes_config(max_keyframes=2), knn_backend)
    return dataclasses.replace(
        cfg, static=dataclasses.replace(cfg.static, max_scan_points=1024,
                                        max_map_points=2048),
        keyframe=dataclasses.replace(cfg.keyframe, dist_threshold=0.1))


@pytest.mark.parametrize("knn_backend", ["grid", "brute"])
def test_resident_rebuild_step_matches_the_eager_step(knn_backend):
    """Every scan after the first (which makes the program's constants, as
    the warm-up before a capture does) under `HostReadGuard`; the results
    bit-equal to `HostDrivenReplay`'s."""
    n_scans = 3
    cfg = eviction_config(knn_backend)
    batch = small_batch(cfg, n_scans)
    hd = replay.HostDrivenReplay(cfg, loop_every=0, device="cpu")
    state_e, fes_e, eager = hd.run(*hd.init(), hd.split(batch))

    run = replay.make_pipeline_replay(cfg, loop_every=0, device="cpu")
    staged = run.stage(batch)
    prog = run.program
    prog.load(*run.init(), torch.zeros(6), staged)
    outs = prog.empty_outputs(n_scans)
    prog.finish_scan(prog.map_scan(staged, 0), outs, 0)
    with H.HostReadGuard():
        for i in range(1, n_scans):
            prog.finish_scan(prog.map_scan(staged, i), outs, i)
    iters = n(outs.iters)
    # what the comparison crosses: the runnable gate (no map at the first
    # scan), the 30-iteration cap and evictions
    assert iters[0] == 0 and iters.max() == cfg.registration.max_iterations
    assert int(prog.state.evict_count) >= 1
    for name in ("poses", "iters", "degenerate"):
        assert torch.equal(getattr(outs, name), getattr(eager, name)), name
    torch.testing.assert_close(outs.fused_last, eager.fused_last, rtol=0,
                               atol=1e-6)
    assert_trees_equal(prog.state, state_e)
    assert_trees_equal(prog.fes, fes_e)


def test_rebuild_pipeline_replay_matches_jax():
    """`make_pipeline_replay` against the JAX monolith, free running and
    with the JAX front-end's state carried into each scan."""
    ref = reference()
    cfg, batch = H.small_rebuild_inputs()
    run = replay.make_pipeline_replay(cfg, loop_every=H.SMALL_REBUILD_LOOP_EVERY,
                                      device="cpu")
    state, fes, out = run(*run.init(), batch)
    assert int(state.store.count) == int(ref["keyframes"])
    assert int(n(out.iters).max()) >= 1 and bool(fes.initialized)

    prog = run.program
    map_scan = prog.map_scan

    def carried(staged, i):
        replay._copy_into(prog.fes, H.imu_state_of(ref, i))
        return map_scan(staged, i)

    prog.map_scan = carried
    _, _, carried_out = run(*run.init(), batch)
    assert_near_reference(out, ref, carried_iters=n(carried_out.iters))
    assert_near_reference(carried_out, ref)


def test_rebuild_chunked_replay_matches_jax():
    """`ChunkedReplay` against the JAX monolith: the detector and the
    correction after each chunk, where the monolith runs them at the same
    cadence scans."""
    ref = reference()
    cfg, batch = H.small_rebuild_inputs()
    cr = replay.ChunkedReplay(cfg, loop_every=H.SMALL_REBUILD_LOOP_EVERY,
                              device="cpu")
    state, _, out = cr.run(*cr.init(), cr.split(batch))
    assert int(state.store.count) == int(ref["keyframes"])
    assert_near_reference(out, ref)


def test_rebuild_cadence_correction_reads_the_corrected_store():
    """A loop queued after four scans, consumed at the next keyframe save
    and solved at the cadence scan; the two scans after it assemble their
    local map from the corrected store.  The resident program and
    `HostDrivenReplay` bit-equal throughout."""
    L = 4
    cfg = rebuild(dense_keyframes_config())
    batch = small_batch(cfg, 10)
    first = replay.ReplayBatch(*(a[:L] for a in batch))
    second = replay.ReplayBatch(*(a[L:] for a in batch))
    hd = replay.HostDrivenReplay(cfg, loop_every=L, device="cpu")
    state, fes, _ = hd.run(*hd.init(), hd.split(first))
    assert int(state.store.count) >= 2
    state, added = lio.inject_loop_constraint(
        state, 0, 1, torch.zeros(6), torch.full((6,), 1e2))
    assert bool(added)

    corrected = []
    full_correct = hd.full_correct

    def noting(st):
        if bool(st.needs_full_solve):
            corrected.append(st.store.poses.clone())
        return full_correct(st)

    hd.full_correct = noting
    state_e, fes_e, eager = hd.run(state, fes, hd.split(second))
    # the correction ran at the cadence scan and moved the stored poses
    assert len(corrected) == 1 and int(state_e.loop_count) == 1
    assert not torch.equal(corrected[0], state_e.store.poses)

    run = replay.make_pipeline_replay(cfg, loop_every=L, device="cpu")
    state_r, fes_r, res = run(state, fes, second)
    for name in ("poses", "iters", "degenerate"):
        assert torch.equal(getattr(res, name), getattr(eager, name)), name
    assert_trees_equal(state_r, state_e)
    assert_trees_equal(fes_r, fes_e)


def test_corner_config_replays_the_surface_path():
    """The corner config through `make_pipeline_replay`,
    `make_pipeline_replay_carry` and `ChunkedReplay` on the incremental
    map, and through `make_pipeline_replay` on the rebuild-mode map: the
    surface config's outputs bit for bit, and every state leaf but the
    (unused, wider) corner store."""
    n_scans = L = 2
    base = dense_keyframes_config()
    batch = small_batch(base, n_scans)
    corner_free = lambda st: [(p, x) for p, x in leaves(st)
                              if ".corner_" not in p]

    def same(a, b):
        for name in ("poses", "iters", "degenerate", "fused_last"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name

    for cfg in (base, rebuild(base)):
        surf = replay.make_pipeline_replay(cfg, loop_every=L, device="cpu")
        corner = replay.make_pipeline_replay(with_corners(cfg), loop_every=L,
                                             device="cpu")
        st_s, _, out_s = surf(*surf.init(), batch)
        st_c, _, out_c = corner(*corner.init(), batch)
        same(out_c, out_s)
        for (p, x), (_, y) in zip(corner_free(st_c), corner_free(st_s)):
            assert torch.equal(x, y), p
        assert not bool(st_c.store.corner_masks.any())
        if cfg is base:
            cr = replay.ChunkedReplay(with_corners(cfg), loop_every=L,
                                      device="cpu")
            _, _, out_cr = cr.run(*cr.init(), cr.split(batch))
            same(out_cr, out_s)
            carried = []
            for c in (cfg, with_corners(cfg)):
                chunk = replay.make_pipeline_replay_carry(c, device="cpu")
                _, _, last, out_k = chunk(*corner.init(), torch.zeros(6), batch)
                assert torch.equal(last, out_k.poses[-1])
                carried.append(out_k)
            same(*carried)


def test_resident_step_refuses_a_corner_cloud():
    cfg = with_corners(dense_keyframes_config())
    step = lio.make_lio_step(cfg, device="cpu", resident=True)
    inp = lio.empty_scan_input(cfg.static.max_scan_points)
    inp = inp._replace(corner=inp.cloud)
    with pytest.raises(NotImplementedError, match="no corner cloud"):
        step(lio.init_state(cfg), inp)
    # the eager step takes it: the LOAM corner term of the Runner
    state, out = lio.make_lio_step(cfg, device="cpu")(lio.init_state(cfg), inp)
    assert out.is_keyframe


@pytest.mark.parametrize("mode", ["rebuild", "corner", "rebuild_corner"])
def test_programs_build_at_every_config(mode):
    """The three programs build at each config the JAX programs run (the
    resident step raised at construction before)."""
    cfg = dense_keyframes_config()
    if "rebuild" in mode:
        cfg = rebuild(cfg)
    if "corner" in mode:
        cfg = with_corners(cfg)
    makers = (lambda: replay.make_pipeline_replay(cfg, device="cpu"),
              lambda: replay.make_pipeline_replay_carry(cfg, device="cpu"),
              lambda: replay.ChunkedReplay(cfg, device="cpu"))
    for make in makers:
        assert make() is not None
