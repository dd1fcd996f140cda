"""The mapping step's pose tail on the card: the wrapper of
`csrc/pose_update.cu`.

Between the registration and the keyframe save, `pipeline/lio.
make_lio_step`'s step keeps the registered pose where the scan has a map,
runs transformUpdate (`ops/registration.transform_update`: roll and pitch
slerped toward the IMU attitude, then clamped) and the keyframe gate
(`pipeline/keyframes.should_add_keyframe`); after the save it takes the
incremental odometry (`utils/se3.pose6_between`).  As torch operations, the
plain chain the CPU runs, that is about 800 launches a scan; on CUDA
tensors it is two:

- `update(reg_pose, guess, has_map, imu_rpy, imu_available, poses, count,
  p)` -> (pose (6,), is_kf () bool), the pose tail of one scan against the
  keyframe store's `poses` (K, 6) and `count`;
- `between(a, b)` -> `pose6_between(a, b)` (6,); on CPU tensors the plain
  `utils/se3.pose6_between`.

The update reads `count` and the last keyframe's row on the device; both
read nothing on the host and write into `torch.empty` outputs (the pose
and the flag are views of one buffer, the flag the bytes of its last
word), so both can be captured in a CUDA graph; nothing here waits for the
device.  They agree with the plain chain to float32 rounding (the source
says where) and repeat their bits.  A tensor the kernels do not take (a
shape, a dtype, a device other than the others', or not contiguous)
raises `ValueError`.

A launch counts in `_build.LAUNCHES` (`ops/_build.launch`) under
"pose_update" or "pose_between".
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lio_slam_tpu_torch.ops import _build
from lio_slam_tpu_torch.utils import se3

# the pose (6), the keyframe flag's word
OUT_WORDS = 7


class Params(NamedTuple):
    """The config's scalars as the kernel takes them (float32 each): the
    slerp's weight and its complement, the clamps and the gate's
    thresholds."""
    weight: float
    keep: float                 # 1 - weight, formed in float64 as slerp does
    rotation_tolerance: float
    z_tolerance: float
    angle_threshold: float
    dist_threshold: float


def params(cfg) -> Params:
    """The kernel's scalars for a `Config`."""
    t = cfg.imu.imu_rpy_weight
    r, k = cfg.registration, cfg.keyframe
    return Params(t, 1.0 - t, r.rotation_tolerance, r.z_tolerance,
                  k.angle_threshold, k.dist_threshold)


def _check(dev, **named):
    """Raise `ValueError` unless each of `named`, (tensor, dtype, shape) by
    name, is a contiguous tensor of that dtype and shape on `dev` (a shape
    of None: any (K, 6) with K >= 1)."""
    bad = []
    for name, (x, dtype, shape) in named.items():
        fits = (x.shape[-1:] == (6,) and x.dim() == 2 and x.shape[0] >= 1
                if shape is None else tuple(x.shape) == shape)
        if x.device != dev or x.dtype != dtype or not fits \
                or not x.is_contiguous():
            bad.append(f"{name} {x.dtype} {tuple(x.shape)} on {x.device}")
    if bad:
        raise ValueError("the pose tail's kernels take contiguous float32 "
                         "poses, bool flags and an int32 count on one "
                         "device, got " + ", ".join(bad))


def update_launch(lib, reg_pose, guess, has_map, imu_rpy, imu_available,
                  poses, count, p: Params, stream) -> tuple:
    """One launch of the pose tail through `lib` on `stream` (the card's
    build, or the tests' emulated one with CPU tensors and no stream):
    (cudaError_t, (pose (6,), is_kf () bool), views of one buffer)."""
    f32, b = torch.float32, torch.bool
    _check(guess.device, reg_pose=(reg_pose, f32, (6,)),
           guess=(guess, f32, (6,)), has_map=(has_map, b, ()),
           imu_rpy=(imu_rpy, f32, (3,)), imu_available=(imu_available, b, ()),
           poses=(poses, f32, None), count=(count, torch.int32, ()))
    out = torch.empty(OUT_WORDS, dtype=f32, device=guess.device)
    err = lib.lio_pose_update(
        reg_pose.data_ptr(), guess.data_ptr(), has_map.data_ptr(),
        imu_rpy.data_ptr(), imu_available.data_ptr(), poses.data_ptr(),
        count.data_ptr(), poses.shape[0], *p, out.data_ptr(), stream)
    return err, (out[:6], out[6:].view(b)[0])


def between_launch(lib, a, b, stream) -> tuple:
    """One launch of `pose6_between(a, b)` through `lib` on `stream`:
    (cudaError_t, the (6,) pose)."""
    _check(a.device, a=(a, torch.float32, (6,)), b=(b, torch.float32, (6,)))
    out = torch.empty(6, dtype=torch.float32, device=a.device)
    err = lib.lio_pose_between(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               stream)
    return err, out


def update(reg_pose, guess, has_map, imu_rpy, imu_available, poses, count,
           p: Params) -> tuple:
    """The pose tail on the card (see `update_launch`); `poses` and `count`
    the keyframe store's."""
    return _build.launch("pose_update", guess.device, update_launch,
                         _build.load_kernels(), reg_pose, guess, has_map,
                         imu_rpy, imu_available, poses, count, p)


def between(a, b) -> torch.Tensor:
    """`pose6_between(a, b)`: on CUDA tensors one launch (see
    `between_launch`), on CPU tensors `utils/se3.pose6_between`, the plain
    form the tests hold the kernel to."""
    if not a.is_cuda:
        return se3.pose6_between(a, b)
    return _build.launch("pose_between", a.device, between_launch,
                         _build.load_kernels(), a, b)
