"""Relocalization of the port against the JAX package (mirrors
tests/test_relocalization.py): a map built by the JAX mapping step is
carried into the port (`convert.from_numpy`), and a fresh scan is
relocalized in it by both packages.

Tolerances: the match (success, keyframe) is equal; the descriptor
distance within 1e-5 (the same float32 arithmetic over centroids summed in
another order); the refined pose within 2e-3 m / rad of the JAX pose (a
float32 GN registration of a few iterations, the loop verification's
tolerance in tests/test_torch_runner.py), and within the JAX test's limits
of the truth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import n, t
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.pipeline import lio as jlio
from lio_slam_tpu.pipeline import relocalization as jreloc
from lio_slam_tpu.utils import pointcloud as jpc
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch import convert
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.ops import _build
from lio_slam_tpu_torch.pipeline import relocalization as treloc
from lio_slam_tpu_torch.utils import pointcloud as tpc
from lio_slam_tpu_torch.utils import se3


def cfg_small(m):
    """The configuration of tests/test_relocalization.py."""
    return m.Config(
        static=m.StaticConfig(max_raw_points=4096, max_scan_points=4096,
                              max_map_points=16384, max_keyframes=32,
                              max_keyframe_points=2048, max_loop_queue=2,
                              max_gps_queue=2, window_size=8,
                              icp_submap_points=8192),
        registration=m.RegistrationConfig(degeneracy_eig_thresh=10.0),
        loop=m.LoopClosureConfig(search_num=3),
        keyframe=m.KeyframeConfig(dist_threshold=0.5))


@pytest.fixture(scope="module")
def mapped():
    """Twelve JAX mapping steps (the JAX test's map), as numpy leaves."""
    cfg = cfg_small(jax_config)
    seq = synthetic.make_sequence(n_scans=12, n_points=4096, seed=0, speed=3.0)
    step = jlio.make_lio_step(cfg)
    state = jlio.init_state(cfg)
    prev = None
    for i in range(12):
        if i == 0:
            guess, gvalid = np.zeros(6, np.float32), False
        else:
            inc = se3.pose6_between(t(seq.poses[i - 1]), t(seq.poses[i]))
            guess, gvalid = se3.pose6_compose(t(prev), inc).numpy(), True
        inp = jlio.ScanInput(
            cloud=jpc.Cloud(xyz=jnp.asarray(seq.scans[i]),
                            mask=jnp.asarray(seq.scan_masks[i])),
            stamp=jnp.float32(seq.stamps[i]), init_guess=jnp.asarray(guess),
            guess_valid=jnp.asarray(gvalid), imu_rpy=jnp.asarray(seq.imu_rpy[i]),
            imu_available=jnp.asarray(True), gps_pos=jnp.zeros(3),
            gps_info=jnp.zeros(3), gps_valid=jnp.asarray(False))
        state, out = step(state, inp)
        prev = np.asarray(out.pose)
    return jax.tree.map(np.array, state), seq


def both(mapped, scan, mask):
    state, _ = mapped
    ja = jreloc.make_relocalizer(cfg_small(jax_config))(
        jax.tree.map(jnp.asarray, state),
        jpc.Cloud(xyz=jnp.asarray(scan), mask=jnp.asarray(mask)))
    before = _build.LAUNCHES.copy(), _build.CAPTURED.copy()
    tb = treloc.make_relocalizer(cfg_small(port_config))(
        convert.from_numpy(state), tpc.Cloud(xyz=t(scan), mask=t(mask)))
    assert (_build.LAUNCHES, _build.CAPTURED) == before  # CPU: plain
    return ja, tb


@pytest.mark.parametrize("yaw,dx", [(0.35, 0.3), (-0.2, -0.1)])
def test_relocalize_known_place(mapped, yaw, dx):
    state, seq = mapped
    assert int(state.store.count) >= 4
    # observe the world again from near the pose of scan 5, yawed
    offset = np.array([0, 0, yaw, dx, -0.2, 0.0], np.float32)
    true_rel = se3.pose6_between(t(seq.poses[0]), t(seq.poses[5]))
    query_pose_map = se3.pose6_compose(true_rel, t(offset)).numpy()
    world_pose = se3.pose6_compose(t(seq.poses[5]), t(offset)).numpy()
    scan, mask = synthetic.observe(seq.world, world_pose, 4096,
                                   rng=np.random.RandomState(9))
    ja, tb = both(mapped, scan, mask)
    assert bool(tb.success) and bool(ja.success)
    assert int(tb.matched_kf) == int(ja.matched_kf) >= 0
    assert abs(float(tb.sc_distance) - float(ja.sc_distance)) < 1e-5
    np.testing.assert_allclose(n(tb.pose), n(ja.pose), atol=2e-3)
    assert abs(float(tb.fitness) - float(ja.fitness)) < 2e-3
    err = np.abs(n(tb.pose) - query_pose_map)
    err[2] = (err[2] + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(err[3:]).max() < 0.3, err
    assert abs(err[2]) < 0.1, err


def test_relocalize_rejects_unknown_place(mapped):
    rs = np.random.RandomState(3)
    ang = rs.uniform(0, np.pi / 4, 4096)
    r = rs.uniform(3, 60, 4096)
    scan = np.stack([r * np.cos(ang), r * np.sin(ang), r * 0.1], 1).astype(np.float32)
    ja, tb = both(mapped, scan, np.ones(4096, bool))
    assert not bool(tb.success) and not bool(ja.success)
    assert int(tb.matched_kf) == int(ja.matched_kf)
    if int(tb.matched_kf) < 0:
        assert n(tb.pose).tolist() == [0.0] * 6
