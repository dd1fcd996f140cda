"""The mapping step's pose-tail kernels (`lio_slam_tpu_torch/ops/csrc/
pose_update.cu`: `pose_update`, the select on has_map, transformUpdate and
the keyframe gate; `pose_between`, the incremental odometry) run on the
CPU: compiled with g++ against `tests/cuda_emulator.h`
(`tests/torch_port_cuda_emulator.py`), launched through `ops/_build.launch`
and the wrapper's own `update_launch` and `between_launch`, and held to the
plain chain (`registration.transform_update`,
`keyframes.should_add_keyframe`, `se3.pose6_between`) on 200 seeded calls
of each kernel and on the edge cases of `torch_port_helpers.
POSE_TAIL_CASES` and `POSE_BETWEEN_CASES`: the IMU unavailable, the
slerp's dot < 0 flip and its small-angle branch, Shepperd's branches,
pitch within 1e-3 of +-pi/2, the clamps, a store of 0, 1 and K keyframes,
a non-finite registration left unread where the scan has no map, each
gate threshold missed and crossed by 1e-4.  The card holds the compiled
kernels to the same calls (tests/test_torch_cuda.py).

Of `matrix_to_quat`'s four branches transformUpdate reaches the first two
with finite angles (its rotations are about x alone, so R00 = 1 is never
below R11 or R22) and the last with a NaN angle; the third it cannot reach.

They agree to float32 rounding (angles within 2e-6, positions within 1e-6
of the operands' largest), the keyframe flags equal wherever the plain
gate's delta lies more than 1e-5 from its thresholds; a second launch
repeats the bits.  The same calls hold the kernels to the JAX package's
`transform_update`, `should_add_keyframe` and `pose6_between` within the
same bounds (pose6_between through the float64 chain, as across devices).
The bounds are `torch_port_helpers.POSE_TAIL_*`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_cuda_emulator as E
from torch_port_helpers import (POSE_BETWEEN_CASES, POSE_TAIL_CASES,
                                POSE_TAIL_SEEDS, assert_pose_between_accurate,
                                assert_pose_between_matches,
                                assert_pose_tail_matches, assert_same_bits,
                                pose_between_case, pose_between_pairs,
                                pose_tail_case, pose_tail_calls,
                                pose_tail_params)
from lio_slam_tpu.ops import registration as jreg
from lio_slam_tpu.pipeline import keyframes as jkf
from lio_slam_tpu.utils import se3 as jse3
from lio_slam_tpu_torch.config import Config
from lio_slam_tpu_torch.ops import _build
from lio_slam_tpu_torch.ops import pose_update as pu


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return E.build_pose_update(tmp_path_factory.mktemp("emulated_pose"))


def update(lib, call):
    return E.launch("pose_update", pu.update_launch, lib, *call)


def between(lib, a, b):
    return E.launch("pose_between", pu.between_launch, lib, a, b)


def held(lib, call):
    """The kernel's (pose, is_kf) on `call`, held to the plain chain; a
    second launch repeats the bits."""
    pose, is_kf = update(lib, call)
    assert_pose_tail_matches(call, pose, is_kf)
    again = update(lib, call)
    assert_same_bits(pose, again[0])
    assert bool(again[1]) == bool(is_kf)
    return pose, is_kf


@functools.partial(jax.jit, static_argnums=7)
def _jax_tail(reg_pose, guess, has_map, imu_rpy, imu_available, poses, count,
              p):
    pose = jnp.where(has_map, reg_pose, guess)
    pose = jreg.transform_update(pose, imu_rpy, imu_available, p.weight,
                                 p.rotation_tolerance, p.z_tolerance)
    store = jkf.empty_store(poses.shape[0], 1)._replace(poses=poses,
                                                        count=count)
    is_kf = jkf.should_add_keyframe(store, pose, p.angle_threshold,
                                    p.dist_threshold)
    return pose, is_kf, jse3.pose6_between(poses[jnp.maximum(count - 1, 0)],
                                           pose)


def jax_tail(call):
    """The JAX package's (pose, is_kf, the gate's delta) on `call`, as torch
    tensors."""
    out = _jax_tail(*(jnp.asarray(x.numpy()) for x in call[:7]), call.params)
    return tuple(torch.from_numpy(np.asarray(x).copy()) for x in out)


_jax_between = jax.jit(jse3.pose6_between)


def jax_between(a, b):
    return torch.from_numpy(np.asarray(
        _jax_between(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))).copy())


def group_calls(group):
    """The seeded calls and pairs, or the edge cases'."""
    if group == "seeded":
        return ([c for s in POSE_TAIL_SEEDS for c in pose_tail_calls(s)],
                [p for s in POSE_TAIL_SEEDS for p in pose_between_pairs(s)])
    return ([c for n in POSE_TAIL_CASES for c in pose_tail_case(n)],
            [p for n in POSE_BETWEEN_CASES for p in pose_between_case(n)])


@pytest.mark.parametrize("seed", POSE_TAIL_SEEDS)
def test_pose_update_matches_the_plain_chain(lib, seed):
    for call in pose_tail_calls(seed):
        held(lib, call)


@pytest.mark.parametrize("name", POSE_TAIL_CASES)
def test_pose_update_edge_cases(lib, name):
    for i, call in enumerate(pose_tail_case(name)):
        pose, is_kf = held(lib, call)
        if int(call.count) == 0:          # an empty store: a keyframe
            assert bool(is_kf)
        if name == "unmapped_nonfinite":
            assert bool(torch.isfinite(pose).all())
        if name == "gate_margins":        # missed, then crossed by 1e-4
            assert bool(is_kf) == (i % 2 == 1)


@pytest.mark.parametrize("seed", POSE_TAIL_SEEDS)
def test_pose_between_matches_the_plain_chain(lib, seed):
    for a, b in pose_between_pairs(seed):
        got = between(lib, a, b)
        assert_pose_between_matches(a, b, got)
        assert_same_bits(got, between(lib, a, b))


@pytest.mark.parametrize("name", POSE_BETWEEN_CASES)
def test_pose_between_edge_cases(lib, name):
    for a, b in pose_between_case(name):
        assert_pose_between_matches(a, b, between(lib, a, b))


@pytest.mark.parametrize("group", ["seeded", "edge"])
def test_pose_update_matches_the_jax_package(lib, group):
    """The kernel's pose and flag against the JAX package's
    `transform_update` and `should_add_keyframe` on the same calls."""
    for call in group_calls(group)[0]:
        pose, is_kf = update(lib, call)
        assert_pose_tail_matches(call, pose, is_kf, ref=jax_tail(call))


@pytest.mark.parametrize("group", ["seeded", "edge"])
def test_pose_between_matches_the_jax_package(lib, group):
    """The kernel's `pose6_between` against the JAX package's, through the
    float64 chain."""
    for a, b in group_calls(group)[1]:
        assert_pose_between_accurate(a, b, between(lib, a, b),
                                     jax_between(a, b))


def test_each_launch_counts_once(lib):
    """A launch counts once in `_build.LAUNCHES` under its key, and the
    outputs are views of one buffer: the pose, then the flag's word."""
    call = pose_tail_calls(0)[1]
    before = _build.LAUNCHES.copy()
    pose, is_kf = update(lib, call)
    between(lib, call.reg_pose, pose)
    assert _build.LAUNCHES - before == {"pose_update": 1, "pose_between": 1}
    assert pose.untyped_storage().data_ptr() == \
        is_kf.untyped_storage().data_ptr()
    assert is_kf.data_ptr() - pose.data_ptr() == 6 * 4


def test_params_round_as_the_plain_chain():
    """The kernel's scalars are the config's: the slerp's weight and its
    complement formed in float64, the clamps, the gate's thresholds."""
    cfg = Config()
    p = pu.params(cfg)
    assert p == pose_tail_params(cfg.imu.imu_rpy_weight,
                                 cfg.registration.rotation_tolerance,
                                 cfg.registration.z_tolerance,
                                 cfg.keyframe.angle_threshold,
                                 cfg.keyframe.dist_threshold)
    assert p.keep == 1.0 - cfg.imu.imu_rpy_weight


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(lib, bad):
    call = pose_tail_calls(0)[0]
    if bad == "dtype":
        call = call._replace(count=call.count.to(torch.int64))
    elif bad == "shape":
        call = call._replace(imu_rpy=torch.zeros(6))
    elif bad == "strided":
        call = call._replace(reg_pose=torch.zeros(12)[::2])
    else:
        call = call._replace(poses=call.poses.to("meta"))
    before = _build.LAUNCHES.copy()
    with pytest.raises(ValueError, match="pose tail"):
        update(lib, call)
    assert _build.LAUNCHES == before
