"""Checkpoints across the two packages (mirrors tests/test_checkpoint.py):
a checkpoint the JAX package writes loads in the port and one the port
writes loads in the JAX package, every leaf bit-equal with its dtype kept;
five scans continued from the other package's checkpoint (a keyframe
among them) track that package (keyframe decisions equal, poses within 1e-4 m and rad, the
runner tests' tolerance); a capacity mismatch names the leaf; the write is
atomic."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import n, t
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.pipeline import checkpoint as jck
from lio_slam_tpu.pipeline import imu_frontend as jfe
from lio_slam_tpu.pipeline import lio as jlio
from lio_slam_tpu.utils import pointcloud as jpc
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.pipeline import checkpoint as tck
from lio_slam_tpu_torch.pipeline import imu_frontend as tfe
from lio_slam_tpu_torch.pipeline import lio as tlio
from lio_slam_tpu_torch.utils import pointcloud as tpc
from lio_slam_tpu_torch.utils import se3 as tse3


def cfg_small(m):
    """The configuration of tests/test_checkpoint.py."""
    return m.Config(
        static=m.StaticConfig(max_raw_points=2048, max_scan_points=2048,
                              max_map_points=8192, max_keyframes=16,
                              max_keyframe_points=1024, max_loop_queue=2,
                              max_gps_queue=2, window_size=8),
        registration=m.RegistrationConfig(degeneracy_eig_thresh=10.0))


SEQ = synthetic.make_sequence(n_scans=11, n_points=2048, seed=0)
CONT = (6, 11)           # the scans continued from a checkpoint


def guess_after(prev, i):
    if prev is None:
        return np.zeros(6, np.float32), False
    inc = tse3.pose6_between(t(SEQ.poses[i - 1]), t(SEQ.poses[i]))
    return tse3.pose6_compose(t(prev), inc).numpy(), True


def run_jax(state, lo, hi, prev=None):
    step = jlio.make_lio_step(cfg_small(jax_config))
    poses, kfs = [], []
    for i in range(lo, hi):
        guess, valid = guess_after(prev, i)
        inp = jlio.ScanInput(
            cloud=jpc.Cloud(xyz=jnp.asarray(SEQ.scans[i]),
                            mask=jnp.asarray(SEQ.scan_masks[i])),
            stamp=jnp.float32(SEQ.stamps[i]), init_guess=jnp.asarray(guess),
            guess_valid=jnp.asarray(valid), imu_rpy=jnp.asarray(SEQ.imu_rpy[i]),
            imu_available=jnp.asarray(True), gps_pos=jnp.zeros(3),
            gps_info=jnp.zeros(3), gps_valid=jnp.asarray(False))
        state, out = step(state, inp)
        prev = np.asarray(out.pose)
        poses.append(prev)
        kfs.append(bool(out.is_keyframe))
    return state, np.stack(poses), kfs


def run_port(state, lo, hi, prev=None):
    step = tlio.make_lio_step(cfg_small(port_config))
    poses, kfs = [], []
    for i in range(lo, hi):
        guess, valid = guess_after(prev, i)
        inp = tlio.ScanInput(
            cloud=tpc.Cloud(xyz=t(SEQ.scans[i]), mask=t(SEQ.scan_masks[i])),
            stamp=t(np.float32(SEQ.stamps[i])), init_guess=t(guess),
            guess_valid=t(np.bool_(valid)), imu_rpy=t(SEQ.imu_rpy[i]),
            imu_available=t(np.bool_(True)), gps_pos=t(np.zeros(3, np.float32)),
            gps_info=t(np.zeros(3, np.float32)), gps_valid=t(np.bool_(False)))
        state, out = step(state, inp)
        prev = n(out.pose)
        poses.append(prev)
        kfs.append(out.is_keyframe)
    return state, np.stack(poses), kfs


def imu_state_with_values(mod, arr):
    """A front-end state whose every leaf holds a distinct value."""
    rs = np.random.RandomState(5)
    R = np.linalg.qr(rs.randn(3, 3))[0].astype(np.float32)
    v = lambda k: arr(rs.randn(k).astype(np.float32))
    return mod.ImuFrontendState(
        nav=mod.pre.NavState(R=arr(R), p=v(3), v=v(3)), bias_gyr=v(3),
        bias_acc=v(3), cov=arr((rs.rand(15, 15) * 1e-3).astype(np.float32)),
        initialized=arr(np.bool_(True)), failure=arr(np.bool_(False)))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Six scans in each package, each saved by its own package."""
    d = tmp_path_factory.mktemp("ck")
    js, jposes, _ = run_jax(jlio.init_state(cfg_small(jax_config)), 0, 6)
    ts, tposes, _ = run_port(tlio.init_state(cfg_small(port_config)), 0, 6)
    jimu = imu_state_with_values(jfe, jnp.asarray)
    timu = imu_state_with_values(tfe, t)
    jpath, tpath = str(d / "jax.npz"), str(d / "port.npz")
    meta = {"scan_count": 6, "t0": 12.5, "last_correct_t": float("nan")}
    jck.save_checkpoint(jpath, js, jimu, metadata=meta)
    tck.save_checkpoint(tpath, ts, timu, metadata=meta)
    # numpy copies: the JAX step donates the state it is given
    host = lambda tree: jax.tree.map(np.array, tree)
    return (host(js), jposes[-1], host(jimu), jpath), (ts, tposes[-1], timu, tpath)


def assert_leaves_equal(jax_tree, port_tree):
    ja = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_tree)]
    tb = [n(x) for x in tck._leaves(port_tree)]
    assert len(ja) == len(tb)
    for i, (a, b) in enumerate(zip(ja, tb)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")


def test_jax_checkpoint_loads_in_the_port(saved):
    (js, _, jimu, jpath), _ = saved
    state, imu, meta = tck.load_checkpoint(jpath, cfg_small(port_config),
                                           device="cpu")
    assert isinstance(state, tlio.LioState) and isinstance(imu, tfe.ImuFrontendState)
    assert_leaves_equal(js, state)
    assert_leaves_equal(jimu, imu)
    assert meta["scan_count"] == 6 and meta["t0"] == 12.5
    assert np.isnan(meta["last_correct_t"])
    assert int(state.store.count) >= 2 and int(n(state.map_grid.counts).sum()) > 0


def test_port_checkpoint_loads_in_jax(saved):
    _, (ts, _, timu, tpath) = saved
    state, imu, meta = jck.load_checkpoint(tpath, cfg_small(jax_config))
    assert_leaves_equal(state, ts)
    assert_leaves_equal(imu, timu)
    assert meta["scan_count"] == 6


def test_port_state_round_trips(saved):
    _, (ts, _, timu, tpath) = saved
    state, imu, _ = tck.load_checkpoint(tpath, cfg_small(port_config))
    for a, b in zip(tck._leaves(ts), tck._leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(n(b), n(a))
    for a, b in zip(tck._leaves(timu), tck._leaves(imu)):
        np.testing.assert_array_equal(n(b), n(a))


def test_continuing_from_either_checkpoint_tracks_its_writer(saved):
    """Five more scans: the port from the JAX checkpoint against JAX
    continuing its own state, and JAX from the port's checkpoint against
    the port continuing its own."""
    (js, jprev, _, jpath), (ts, tprev, _, tpath) = saved
    port_from_jax, _, _ = tck.load_checkpoint(jpath, cfg_small(port_config))
    _, pa, ka = run_jax(jax.tree.map(jnp.asarray, js), *CONT, prev=jprev)
    _, pb, kb = run_port(port_from_jax, *CONT, prev=jprev)
    assert kb == ka and any(ka)
    np.testing.assert_allclose(pb, pa, atol=1e-4)
    jax_from_port, _, _ = jck.load_checkpoint(tpath, cfg_small(jax_config))
    _, pc_, kc = run_port(ts, *CONT, prev=tprev)
    _, pd, kd = run_jax(jax_from_port, *CONT, prev=tprev)
    assert kd == kc == ka
    np.testing.assert_allclose(pd, pc_, atol=1e-4)
    rel = np.stack([tse3.pose6_between(t(SEQ.poses[0]), t(p)).numpy()
                    for p in SEQ.poses[CONT[0]:CONT[1]]])
    assert np.abs(pb - rel)[:, 3:].max() < 0.05


def test_capacity_mismatch_names_the_leaf(saved):
    (_, _, _, jpath), (_, _, _, tpath) = saved
    bigger = cfg_small(port_config)
    bigger = dataclasses.replace(
        bigger, static=dataclasses.replace(bigger.static, max_keyframes=32))
    for path in (jpath, tpath):
        with pytest.raises(ValueError, match=r"checkpoint leaf 0 shape \(16, 6\)"):
            tck.load_checkpoint(path, bigger)


def test_format_version_checked(tmp_path):
    cfg = cfg_small(port_config)
    p = str(tmp_path / "v.npz")
    tck.save_checkpoint(p, tlio.init_state(cfg))
    with np.load(p) as z:
        arrays = dict(z)
    arrays["__manifest__"] = str(arrays["__manifest__"]).replace(
        '"format_version": 2', '"format_version": 1')
    np.savez(p, **arrays)
    with pytest.raises(ValueError, match="format 1"):
        tck.load_checkpoint(p, cfg)


def test_atomic_write(tmp_path):
    cfg = cfg_small(port_config)
    state = tlio.init_state(cfg)
    p = str(tmp_path / "sub" / "a.npz")
    tck.save_checkpoint(p, state)
    tck.save_checkpoint(p, state)     # overwrite cleanly
    assert os.listdir(str(tmp_path / "sub")) == ["a.npz"]
    s2, imu2, meta = tck.load_checkpoint(p, cfg)
    assert imu2 is None and meta == {}
    assert int(s2.store.count) == 0
    j2, jimu2, _ = jck.load_checkpoint(p, cfg_small(jax_config))
    assert jimu2 is None
