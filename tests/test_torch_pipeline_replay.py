"""The port's device-resident replay programs (`make_pipeline_replay`,
`make_pipeline_replay_carry`, `ChunkedReplay` of `pipeline/replay.py`)
against the JAX package's `lax.scan` programs, and the resident step
against the eager one.  On the CPU the resident step runs eagerly; on the
card each scan is a captured CUDA graph (tests/test_torch_cuda.py).

At the config of tests/test_replay.py (2048 points, K=16, W=16):

- the three programs against JAX's on the same numpy batch: poses within
  1e-3 m and 0.01 deg, the same GN iterations and degenerate flags, the
  TransformFusion output within 1e-3;
- the resident step against the eager one (`HostDrivenReplay`) over scans
  that cross evictions, the 30-iteration cap and the runnable gate:
  poses, iterations, degenerate flags and every leaf of the final state
  bit-equal; the TransformFusion output within 1e-6 (the resident
  programs fuse the whole rate train and keep its last pose, as the JAX
  scan programs do, where `HostDrivenReplay` fuses the last pose alone:
  the batched products may round the last bit apart);
- the resident step under `HostReadGuard`, which raises on every host
  read and on host data sent to the device;
- `needs_full_solve` after the scans, the stated departure of the cadence
  correction, and the repeat run.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H
from torch_port_helpers import n
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.pipeline import imu_frontend as jfe
from lio_slam_tpu.pipeline import lio as jlio
from lio_slam_tpu.pipeline import replay as jreplay
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.pipeline import replay
from test_torch_replay import numpy_batch, replay_config


def jax_batch(batch):
    return jreplay.ReplayBatch(*(jnp.asarray(a) for a in batch))


def assert_outs_match(out, ref):
    """The parity limits of tests/test_torch_replay.py."""
    poses, jposes = n(out.poses), np.asarray(ref.poses)
    assert poses.shape == jposes.shape and np.isfinite(poses).all()
    assert np.abs(poses[:, 3:] - jposes[:, 3:]).max() < 1e-3
    assert np.abs(poses[:, :3] - jposes[:, :3]).max() < np.radians(0.01)
    np.testing.assert_array_equal(n(out.iters), np.asarray(ref.iters))
    np.testing.assert_array_equal(n(out.degenerate),
                                  np.asarray(ref.degenerate))
    np.testing.assert_allclose(n(out.fused_last), np.asarray(ref.fused_last),
                               atol=1e-3)


def leaves(tree, path=""):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, tuple):
        for name, x in zip(getattr(tree, "_fields", range(len(tree))), tree):
            yield from leaves(x, f"{path}.{name}")


def assert_trees_equal(a, b):
    differ = [p for (p, x), (_, y) in zip(leaves(a), leaves(b))
              if not torch.equal(x, y)]
    assert not differ, f"leaves differ: {differ}"


def test_pipeline_replay_matches_jax():
    n_scans = 8
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=0)
    batch = numpy_batch(seq, replay_config(port_config), n_scans)
    jcfg = replay_config(jax_config)
    jstate, jfes, jout = jreplay.make_pipeline_replay(jcfg, loop_every=4)(
        jlio.init_state(jcfg), jfe.init_state(), jax_batch(batch))

    run = replay.make_pipeline_replay(replay_config(port_config),
                                      loop_every=4, device="cpu")
    state, fes = run.init()
    state, fes, out = run(state, fes, batch)
    assert run.capture_seconds is None           # no graph on the CPU
    assert_outs_match(out, jout)
    assert int(n(out.iters).max()) >= 1
    assert int(state.store.count) == int(jstate.store.count)
    assert int(state.loop_count) == int(jstate.loop_count)
    assert bool(fes.initialized) and not bool(fes.failure)


def test_chunked_and_carry_replays_match_jax():
    """`ChunkedReplay` against JAX's over two chunks of 4 scans; then the
    port's `make_pipeline_replay_carry` threading `last_pose` across the
    same two chunks against JAX's (the one `ChunkedReplay` runs)."""
    n_scans, L = 8, 4
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=0)
    batch = numpy_batch(seq, replay_config(port_config), n_scans)
    jcr = jreplay.ChunkedReplay(replay_config(jax_config), loop_every=L)
    jstate, jfes = jcr.init()
    _, _, jout = jcr.run(jstate, jfes, jcr.split(jax_batch(batch)))

    cr = replay.ChunkedReplay(replay_config(port_config), loop_every=L,
                              device="cpu")
    chunks = cr.split(batch)
    assert len(chunks) == 2 and all(a.device.type == "cpu" for a in chunks[0])
    state, fes = cr.init()
    _, _, out = cr.run(state, fes, chunks)
    assert_outs_match(out, jout)

    jstate, jfes = jcr.init()
    jlast = jnp.zeros(6, jnp.float32)
    chunk = replay.make_pipeline_replay_carry(replay_config(port_config),
                                              device="cpu")
    state, fes = cr.init()
    last = torch.zeros(6)
    for k in range(2):
        part = replay.ReplayBatch(*(a[k * L:(k + 1) * L] for a in batch))
        jstate, jfes, jlast, jo = jcr._chunk(jstate, jfes, jlast,
                                              jax_batch(part))
        state, fes, last, o = chunk(state, fes, last, part)
        assert_outs_match(o, jo)
        np.testing.assert_allclose(n(last), np.asarray(jlast), atol=1e-3)
        assert torch.equal(last, o.poses[-1])


def dense_keyframes_config(max_keyframes=16):
    """tests/test_replay.py's config with keyframes every 0.3 m and a
    store of `max_keyframes` (the window no wider)."""
    cfg = replay_config(port_config)
    return dataclasses.replace(
        cfg, static=dataclasses.replace(
            cfg.static, max_keyframes=max_keyframes,
            window_size=min(cfg.static.window_size, max_keyframes)),
        keyframe=dataclasses.replace(cfg.keyframe, dist_threshold=0.3))


def eviction_config():
    """A 2-keyframe store: evictions from the fourth scan on."""
    return dense_keyframes_config(max_keyframes=2)


def test_resident_step_matches_the_eager_step():
    n_scans = 8
    cfg = eviction_config()
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=0)
    batch = numpy_batch(seq, cfg, n_scans)
    hd = replay.HostDrivenReplay(cfg, loop_every=0, device="cpu")
    state, fes = hd.init()
    state_e, fes_e, eager = hd.run(state, fes, hd.split(batch))

    run = replay.make_pipeline_replay(cfg, loop_every=0, device="cpu")
    state, fes = run.init()
    state_r, fes_r, res = run(state, fes, batch)
    iters = n(res.iters)
    # what the comparison crosses: the runnable gate (the first scan has
    # no map), the 30-iteration cap and evictions
    assert iters[0] == 0 and iters.max() == cfg.registration.max_iterations
    assert int(state_r.evict_count) >= 2
    for name in ("poses", "iters", "degenerate"):
        assert torch.equal(getattr(res, name), getattr(eager, name)), name
    torch.testing.assert_close(res.fused_last, eager.fused_last, rtol=0,
                               atol=1e-6)
    assert_trees_equal(state_r, state_e)
    assert_trees_equal(fes_r, fes_e)


def test_resident_step_reads_nothing_back():
    """Every scan after the first (which makes the program's constants, as
    the warm-up before a capture does) under `HostReadGuard`: the mapping
    step across evictions, the front-end, TransformFusion."""
    n_scans = 6
    cfg = eviction_config()
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=0)
    run = replay.make_pipeline_replay(cfg, loop_every=0, device="cpu")
    batch = run.stage(numpy_batch(seq, cfg, n_scans))
    prog = run.program
    state, fes = run.init()
    prog.load(state, fes, torch.zeros(6), batch)
    outs = prog.empty_outputs(n_scans)
    prog.finish_scan(prog.map_scan(batch, 0), outs, 0)
    with H.HostReadGuard():
        for i in range(1, n_scans):
            prog.finish_scan(prog.map_scan(batch, i), outs, i)
    assert int(prog.state.evict_count) >= 1
    assert np.isfinite(n(outs.poses)).all()

    with pytest.raises(AssertionError, match="host read"):
        with H.HostReadGuard():
            bool(prog.state.needs_full_solve)
    with pytest.raises(AssertionError, match="host read"):
        with H.HostReadGuard():
            prog.state.store.poses[prog.state.store.count - 1]


def test_full_correction_flag_at_cadence():
    """`needs_full_solve` after every scan of the loop_every=4 replay: it
    never rises where the detector accepts no loop (so the port's
    cadence-only correction and the JAX monolith's per-scan one agree);
    with a loop injected into the pending queue it rises at the keyframe
    save that consumes it and is down again after the next cadence scan,
    where the port solves it (the stated departure: the JAX monolith
    solves at the consuming scan)."""
    n_scans, L = 8, 4
    cfg = dense_keyframes_config()
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=0)
    batch = numpy_batch(seq, cfg, n_scans)
    run = replay.make_pipeline_replay(cfg, loop_every=L, device="cpu")
    prog = run.program
    flags = []
    finish = prog.finish_scan

    def noting(mapped, outs, i):
        finish(mapped, outs, i)
        flags.append(bool(prog.state.needs_full_solve))

    prog.finish_scan = noting
    state, fes = run.init()
    first = replay.ReplayBatch(*(a[:L] for a in batch))
    state, fes, out = run(state, fes, first)
    assert flags == [False] * L

    # a loop constraint between the first two keyframes, queued before the
    # replay's second half: the next keyframe save consumes it
    from lio_slam_tpu_torch.pipeline import lio

    assert int(state.store.count) >= 2
    state, added = lio.inject_loop_constraint(
        state, 0, 1, torch.zeros(6), torch.full((6,), 1e2))
    assert bool(added)
    flags.clear()
    saved = []
    step = prog.step

    def saving(st, inp):
        st, o = step(st, inp)
        saved.append(bool(o.is_keyframe))
        return st, o

    prog.step = saving
    second = replay.ReplayBatch(*(a[L:] for a in batch))
    assert n_scans == 2 * L
    state, fes, _ = run(state, fes, second)
    consumed = saved.index(True)
    assert flags[:consumed] == [False] * consumed
    assert flags[consumed] or consumed == L - 1
    assert not flags[L - 1]                    # solved at the cadence scan
    assert int(state.loop_count) == 1 and not bool(state.needs_full_solve)


def test_replay_matches_repeat_run():
    """tests/test_replay.py's `test_replay_matches_repeat_run`: the same
    inputs give the same poses, here bit for bit, with one program run
    twice."""
    n_scans = 6
    cfg = replay_config(port_config)
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=2)
    batch = numpy_batch(seq, cfg, n_scans)
    run = replay.make_pipeline_replay(cfg, loop_every=0, device="cpu")
    _, _, o1 = run(*run.init(), batch)
    _, _, o2 = run(*run.init(), batch)
    np.testing.assert_array_equal(n(o1.poses), n(o2.poses))
    np.testing.assert_array_equal(n(o1.fused_last), n(o2.fused_last))


def test_programs_need_a_card_unless_asked():
    cfg = replay_config(port_config)
    makers = (lambda: replay.make_pipeline_replay(cfg),
              lambda: replay.make_pipeline_replay_carry(cfg),
              lambda: replay.ChunkedReplay(cfg))
    for make in makers:
        if torch.cuda.is_available():
            make()
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
