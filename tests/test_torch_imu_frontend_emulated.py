"""The IMU front end's kernels (`lio_slam_tpu_torch/ops/csrc/
imu_frontend.cu`: the correction, the rate prediction, TransformFusion) run
on the CPU: compiled with g++ against `tests/cuda_emulator.h`
(`tests/torch_port_cuda_emulator.py`), launched through `ops/_build.launch`
and the wrapper's own `correct_launch`, `predict_launch` and
`fusion_launch`, and held to the
plain front end (`pipeline/imu_frontend.make_frontend_plain`) and to its
float64 answer on the calls of `torch_port_helpers.IMU_CASES`: an
uninitialized state, the first update after initialization (the 1e8
velocity prior), a conditioned state with degenerate false and true, a
diverged state that the failure check resets, piled-up and non-positive
dt, an empty and a full window, a mask that is not a prefix, W = 512, 64
and 32.  The card holds the compiled kernels to the same cases
(tests/test_torch_cuda.py).

They agree to float32 rounding, not bit for bit: the kernels integrate in
one pass in slot order, the plain version in log depth.  The tolerances,
each with its reason, are `torch_port_helpers.IMU_*`.  An anchored state
(uninitialized, or reset) is the plain version's bit for bit but the
rotation, whose sin and cos are the C library's."""

import pytest
import torch

import torch_port_cuda_emulator as E
from torch_port_helpers import (IMU_CASES, IMU_POSE_ATOL, IMU_R_ATOL,
                                assert_imu_state_close, imu_case,
                                imu_case_float64, imu_state_leaves)
from lio_slam_tpu_torch.config import ImuConfig
from lio_slam_tpu_torch.ops import _build
from lio_slam_tpu_torch.ops import imu_frontend as kernels
from lio_slam_tpu_torch.pipeline import imu_frontend as fe

CFG = ImuConfig()
PARAMS = kernels.params(CFG, fe.pileup_min_dt(CFG))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return E.build_imu_frontend(tmp_path_factory.mktemp("emulated_imu"))


def correct(lib, *args):
    return E.launch("imu_correct", kernels.correct_launch, lib, *args, PARAMS)


def predict(lib, *args):
    return E.launch("imu_predict", kernels.predict_launch, lib, *args, PARAMS)


def fusion(lib, *args):
    return E.launch("imu_fusion", kernels.fusion_launch, lib, *args)


def plain_and_float64(case):
    """The plain front end's (correction leaves, pose train, fused train)
    on the case, in float32 and in float64."""
    correct, predict, fusion = fe.make_frontend_plain(CFG)
    out = []
    for state, window, pose, degenerate in (case, imu_case_float64(*case)):
        train = predict(state, *window)
        out.append((imu_state_leaves(correct(state, *window, pose,
                                             degenerate)),
                    train, fusion(pose, train[0], train)))
    return out


@pytest.mark.parametrize("name", IMU_CASES)
def test_kernels_match_the_plain_front_end(lib, name):
    """The three kernels against the plain front end and its float64 answer
    within the IMU_* bounds; a second launch of each repeats the bits."""
    case = imu_case(name)
    state, window, pose, degenerate = case
    got = correct(lib, state, *window, pose, degenerate)
    train = predict(lib, state, *window)
    fused = fusion(lib, pose, train[0], train)
    assert train.shape == (window[0].shape[0], 6) and fused.shape == train.shape
    for ref, ref_train, ref_fused in plain_and_float64(case):
        assert_imu_state_close(got, ref)
        for a, b in ((train, ref_train), (fused, ref_fused)):
            assert float((a.double() - b.double()).abs().max()) <= IMU_POSE_ATOL
    again = correct(lib, state, *window, pose, degenerate)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(predict(lib, state, *window), train)
    assert torch.equal(fusion(lib, pose, train[0], train), fused)


@pytest.mark.parametrize("name", ["uninitialized", "diverged"])
def test_anchored_states_are_the_plain_versions(lib, name):
    """An uninitialized state is anchored at the lidar pose, a diverged one
    reset there with the failure flag: position, zero velocity and biases
    and the prior covariance the plain version's words, the rotation within
    rounding of its sin and cos."""
    case = imu_case(name)
    got = correct(lib, case[0], *case[1], case[2], case[3])
    ref = imu_state_leaves(fe.make_frontend_plain(CFG)[0](
        case[0], *case[1], case[2], case[3]))
    assert float((got[0] - ref[0]).abs().max()) <= IMU_R_ATOL
    for a, b in zip(got[1:6], ref[1:6]):
        assert torch.equal(a, b)
    assert bool(got[6]) and bool(got[7]) == (name == "diverged")


def test_masked_slots_are_skipped(lib):
    """What a masked slot holds, stale samples or NaN, changes no word of
    any kernel's output: the kernels skip masked slots, which the plain
    version integrates as identities."""
    state, (acc, gyr, dt, mask), pose, degenerate = imu_case("scattered")
    dirty = [x.clone() for x in (acc, gyr, dt)]
    for x in dirty:
        x[~mask] = float("nan")
    outs = []
    for a, g, d in ((acc, gyr, dt), dirty):
        train = predict(lib, state, a, g, d, mask)
        outs.append((*correct(lib, state, a, g, d, mask, pose, degenerate),
                     train))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_fusion_takes_any_leading_shape(lib):
    """TransformFusion of one pose and of a (2, W, 6) stack: the rows of
    the (W, 6) train, word for word."""
    state, window, pose, _ = imu_case("conditioned")
    train = predict(lib, state, *window)
    rows = fusion(lib, pose, train[0], train)
    one = fusion(lib, pose, train[0], train[-1])
    stack = fusion(lib, pose, train[0], torch.stack([train, train]))
    assert one.shape == (6,) and torch.equal(one, rows[-1])
    assert stack.shape == (2, *train.shape)
    assert torch.equal(stack[0], rows) and torch.equal(stack[1], rows)


def test_the_wrapper_refuses_shapes_it_does_not_take(lib):
    """A window whose leaves disagree in W, an empty window, and a state
    leaf of the wrong shape raise ValueError before any launch."""
    state, (acc, gyr, dt, mask), pose, degenerate = imu_case("w32")
    bad = [(state, acc[:-1], gyr, dt, mask), (state, acc, gyr, dt, mask[:-1]),
           (state, acc[:0], gyr[:0], dt[:0], mask[:0]),
           (state._replace(cov=state.cov[:9, :9]), acc, gyr, dt, mask)]
    for s, *window in bad:
        with pytest.raises(ValueError):
            correct(lib, s, *window, pose, degenerate)
        with pytest.raises(ValueError):
            predict(lib, s, *window)


@pytest.mark.parametrize("name", ["conditioned", "w64"])
def test_cpu_inputs_run_the_plain_front_end(name):
    """`make_frontend` launches nothing for CPU tensors: its results are
    the plain versions' own words."""
    state, window, pose, degenerate = imu_case(name)
    before = _build.LAUNCHES.copy(), _build.CAPTURED.copy()
    got = fe.make_frontend(CFG)
    ref = fe.make_frontend_plain(CFG)
    outs = []
    for correct, predict, fusion in (got, ref):
        train = predict(state, *window)
        outs.append((*imu_state_leaves(correct(state, *window, pose,
                                               degenerate)),
                     train, fusion(pose, train[0], train)))
    assert (_build.LAUNCHES, _build.CAPTURED) == before
    assert all(torch.equal(a, b) for a, b in zip(*outs))
