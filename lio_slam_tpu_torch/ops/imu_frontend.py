"""The IMU front end on the card: the wrapper of `csrc/imu_frontend.cu`.

`pipeline/imu_frontend.make_frontend` returns the front end's three
functions; their plain versions (`make_frontend_plain` there: the log-depth
preintegration, the float64 15x15 update, the pose train and the pose
compositions as torch operations) dispatch several hundred small
operations a call.  On CUDA tensors each is one launch here:

- `correct(state, acc, gyr, dt, mask, lidar_pose6, degenerate, params)` ->
  the corrected state's leaves (R, p, v, bias_gyr, bias_acc, cov,
  initialized, failure);
- `predict(state, acc, gyr, dt, mask, params)` -> the (W, 6) pose train;
- `fusion(lidar_odom6, imu_front6, imu_back6)` -> the fused poses, shaped
  as `imu_back6` (`(..., 6)`).

`state` is the front end's state (`pipeline/imu_frontend.
ImuFrontendState`: `nav.R`, `nav.p`, `nav.v`, `bias_gyr`, `bias_acc`, `cov`,
`initialized`).  `on_card(...)` says whether the kernels run: False where
every tensor is on the CPU (the caller runs the plain version), True where
all are on one CUDA device, float32 and bool where a mask or flag is; it
raises `ValueError` for a mix of devices or another dtype, and each launch
for a shape the front end does not hold.  There is no fallback between
the two.

The results are views of one buffer a launch writes whole, allocated with
`torch.empty` (the correction's flags are the bytes of its last word), so a
launch can be captured in a CUDA graph; nothing here waits for the device.
The kernels agree with the plain versions to rounding, not bit for bit
(the source says where their sums part), and repeat their bits.

A launch counts in `_build.LAUNCHES` (`ops/_build.launch`) under
"imu_correct", "imu_predict" or "imu_fusion".
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lio_slam_tpu_torch.ops import _build

# the correction's output words: R (9), p, v, bias_gyr, bias_acc (3 each),
# the covariance (225), the flags' word
OUT_WORDS = 21 + 225 + 1


class Params(NamedTuple):
    """The front end's constants as the plain version rounds them: float32
    where it makes float32 tensors of them, float64 where the 15x15 algebra
    takes them."""
    gravity: float
    pileup_dt: float      # min_dt * 0.999: apply_pileup_gate's threshold
    fallback_dt: float    # what a non-positive dt becomes
    acc_noise: float
    gyr_noise: float
    init_cov: float       # the preintegrated covariance starts as init_cov I
    acc_bias_var: float   # acc_bias_noise ** 2 (float64)
    gyr_bias_var: float


def params(cfg, min_dt: float, fallback_dt: float = 1.0 / 50.0,
           init_cov: float = 1e-8) -> Params:
    """The kernels' constants for an `ImuConfig` and the pileup gate's
    `min_dt`."""
    return Params(cfg.gravity, min_dt * 0.999, fallback_dt, cfg.acc_noise,
                  cfg.gyr_noise, init_cov, cfg.acc_bias_noise ** 2,
                  cfg.gyr_bias_noise ** 2)


def _leaves(state) -> tuple:
    return (state.nav.R, state.nav.p, state.nav.v, state.bias_gyr,
            state.bias_acc)


def on_card(*tensors: torch.Tensor, masks=(), state=None) -> bool:
    """True where the kernels run: every tensor of `tensors`, `masks` (bool)
    and `state`'s leaves on one CUDA device; False where none is on one;
    raises `ValueError` for a mix or for a dtype the kernels do not take."""
    floats = list(tensors)
    bools = list(masks)
    if state is not None:
        floats += [*_leaves(state), state.cov]
        bools.append(state.initialized)
    every = floats + bools
    cuda = [x.device.type == "cuda" for x in every]
    if not any(cuda):
        return False
    dev = every[cuda.index(True)].device
    bad = [f"{x.dtype} on {x.device}" for x in floats
           if x.device != dev or x.dtype != torch.float32]
    bad += [f"{x.dtype} on {x.device}" for x in bools
            if x.device != dev or x.dtype != torch.bool]
    if bad:
        raise ValueError("the IMU front end's kernels take float32 tensors "
                         "and bool masks on one CUDA device, got "
                         + ", ".join(bad))
    return True


def _check_window(acc, gyr, dt, mask):
    W = dt.shape[0] if dt.dim() == 1 else -1
    if not (W >= 1 and tuple(acc.shape) == tuple(gyr.shape) == (W, 3)
            and tuple(mask.shape) == (W,)):
        raise ValueError(
            "the IMU front end's kernels take a window of W >= 1 slots, acc "
            f"and gyr (W, 3), dt and mask (W,); got {tuple(acc.shape)}, "
            f"{tuple(gyr.shape)}, {tuple(dt.shape)}, {tuple(mask.shape)}")
    return W


def _check_state(state):
    shapes = [tuple(x.shape) for x in (*_leaves(state), state.cov,
                                       state.initialized)]
    if shapes != [(3, 3), (3,), (3,), (3,), (3,), (15, 15), ()]:
        raise ValueError(f"the IMU front end's state has shapes {shapes}")


def correct_launch(lib, state, acc, gyr, dt, mask, lidar_pose6, degenerate,
                   p: Params, stream) -> tuple:
    """One launch of the correction through `lib` on `stream` (the card's
    build, or the tests' emulated one with CPU tensors and no stream):
    (cudaError_t, the leaves of the corrected state, views of one
    buffer)."""
    W = _check_window(acc, gyr, dt, mask)
    _check_state(state)
    if tuple(lidar_pose6.shape) != (6,) or tuple(degenerate.shape) != ():
        raise ValueError("the correction takes a (6,) lidar pose and a () "
                         f"degenerate flag, got {tuple(lidar_pose6.shape)}, "
                         f"{tuple(degenerate.shape)}")
    out = torch.empty(OUT_WORDS, dtype=torch.float32, device=acc.device)
    held = [x.contiguous() for x in (*_leaves(state), state.cov,
                                     state.initialized, acc, gyr, dt, mask,
                                     lidar_pose6, degenerate)]
    err = lib.lio_imu_correct(
        *(x.data_ptr() for x in held[:11]), W,
        *(x.data_ptr() for x in held[11:]), p.gravity, p.pileup_dt,
        p.fallback_dt, p.acc_noise, p.gyr_noise, p.init_cov, p.acc_bias_var,
        p.gyr_bias_var, out.data_ptr(), stream)
    flags = out[-1:].view(torch.bool)
    return err, (out[:9].view(3, 3), out[9:12], out[12:15], out[15:18],
                 out[18:21], out[21:246].view(15, 15), flags[0], flags[1])


def predict_launch(lib, state, acc, gyr, dt, mask, p: Params,
                   stream) -> tuple:
    """One launch of the rate prediction through `lib` on `stream`:
    (cudaError_t, the (W, 6) pose train)."""
    W = _check_window(acc, gyr, dt, mask)
    _check_state(state)
    out = torch.empty((W, 6), dtype=torch.float32, device=acc.device)
    held = [x.contiguous() for x in (*_leaves(state), acc, gyr, dt, mask)]
    err = lib.lio_imu_predict(*(x.data_ptr() for x in held), W, p.gravity,
                              p.pileup_dt, p.fallback_dt, out.data_ptr(),
                              stream)
    return err, out


def fusion_launch(lib, lidar_odom6, imu_front6, imu_back6,
                  stream) -> tuple:
    """One launch of TransformFusion through `lib` on `stream`:
    (cudaError_t, poses shaped as `imu_back6`)."""
    if (tuple(lidar_odom6.shape) != (6,) or tuple(imu_front6.shape) != (6,)
            or imu_back6.dim() < 1 or imu_back6.shape[-1] != 6
            or imu_back6.numel() == 0):
        raise ValueError(
            "TransformFusion's kernel takes (6,) lidar and first IMU poses and "
            f"(..., 6) IMU poses, got {tuple(lidar_odom6.shape)}, "
            f"{tuple(imu_front6.shape)}, {tuple(imu_back6.shape)}")
    back = imu_back6.contiguous()
    out = torch.empty(back.shape, dtype=torch.float32, device=back.device)
    lidar, front = lidar_odom6.contiguous(), imu_front6.contiguous()
    err = lib.lio_imu_fusion(lidar.data_ptr(), front.data_ptr(),
                             back.data_ptr(), back.numel() // 6,
                             out.data_ptr(), stream)
    return err, out


def correct(state, acc, gyr, dt, mask, lidar_pose6, degenerate,
            p: Params) -> tuple:
    """The correction on the card (see `correct_launch`)."""
    return _build.launch("imu_correct", acc.device, correct_launch,
                         _build.load_kernels(), state, acc, gyr, dt, mask,
                         lidar_pose6, degenerate, p)


def predict(state, acc, gyr, dt, mask, p: Params) -> torch.Tensor:
    """The rate prediction on the card (see `predict_launch`)."""
    return _build.launch("imu_predict", acc.device, predict_launch,
                         _build.load_kernels(), state, acc, gyr, dt, mask, p)


def fusion(lidar_odom6, imu_front6, imu_back6) -> torch.Tensor:
    """TransformFusion on the card (see `fusion_launch`)."""
    return _build.launch("imu_fusion", imu_back6.device, fusion_launch,
                         _build.load_kernels(), lidar_odom6, imu_front6,
                         imu_back6)
