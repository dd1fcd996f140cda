"""The CUDA kernels `lio_slam_tpu_torch/ops/csrc/fused_corr.cu`,
`gn_small.cu`, `window_system.cu`, `imu_frontend.cu` and `pose_update.cu`
compiled for the CPU against `tests/cuda_emulator.h` (g++, C++20) and bound
through ctypes, so that the CPU tests hold the kernels' own source, their
control flow and arithmetic, to the plain versions.  The sources are taken
as they are, with mechanical substitutions: the CUDA runtime header for the
emulator's, and each launch
for `emu_launch`; in `fused_corr.cu` also the dynamic shared array for the
emulator's buffer and the three cp.async helpers' bodies for plain copies.
A substitution that no longer matches raises.  Each build is bound by
the `ops/_build` binder of its source and launched through `_build.launch`
and the wrapper's own marshalling function, with CPU tensors and no stream.

    lib = build(tmp_dir)
    out = fused_ne_emulated(lib, table, hh, scan, mask, pose, counts=None, **kw)
    gn = build_gn_small(tmp_dir)
    out = gn_small_emulated(gn, AtA, Atb, eigh=True)
    ws = build_window_system(tmp_dir)
    H, b = window_system_emulated(ws, graph, count, window)
    imu = build_imu_frontend(tmp_dir)
    leaves = launch("imu_correct", imu_frontend.correct_launch, imu, ...)
    tail = build_pose_update(tmp_dir)
    pose, is_kf = launch("pose_update", pose_update.update_launch, tail, ...)
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
from unittest import mock

import torch

from lio_slam_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "lio_slam_tpu_torch", "ops", "csrc",
                      "fused_corr.cu")
GN_SOURCE = os.path.join(ROOT, "lio_slam_tpu_torch", "ops", "csrc",
                         "gn_small.cu")
WS_SOURCE = os.path.join(ROOT, "lio_slam_tpu_torch", "ops", "csrc",
                         "window_system.cu")
IMU_SOURCE = os.path.join(ROOT, "lio_slam_tpu_torch", "ops", "csrc",
                          "imu_frontend.cu")
POSE_SOURCE = os.path.join(ROOT, "lio_slam_tpu_torch", "ops", "csrc",
                           "pose_update.cu")
HEADER = os.path.join(ROOT, "tests", "cuda_emulator.h")


def _sub(pattern, repl, text, literal=True):
    if literal:
        if pattern not in text:
            raise RuntimeError(f"emulator: the kernel source lost {pattern!r}")
        return text.replace(pattern, repl)
    out, n = re.subn(pattern, repl, text)
    if n == 0:
        raise RuntimeError(f"emulator: the kernel source lost /{pattern}/")
    return out


def emulated_source() -> str:
    """fused_corr.cu with the substitutions that make it a CPU program."""
    s = open(SOURCE).read()
    s = _sub("#include <cuda_runtime.h>", f'#include "{HEADER}"', s)
    s = _sub("extern __shared__ __align__(16) float stage_mem[];",
             "float* stage_mem = emu_dynamic_smem;", s)
    for name, n in (("cp_async16", 4), ("cp_async4", 1)):
        s = _sub(r"(void %s\(float\* smem, const float\* gmem\) \{)(.|\n)*?\n\}"
                 % name, r"\1 emu_copy(smem, gmem, %d); }" % n, s,
                 literal=False)
    s = _sub(r"(void cp_async_wait_all\(\) \{)(.|\n)*?\n\}", r"\1 }", s,
             literal=False)
    s = _sub("kernel<<<blocks, warps * 32, smem, s>>>(",
             "emu_launch(kernel, blocks, warps * 32, smem, ", s)
    return s


def one_thread_source(path: str) -> str:
    """A source whose kernels are one-thread launches (gn_small.cu,
    pose_update.cu) with the substitutions that make it a CPU program."""
    s = open(path).read()
    s = _sub("#include <cuda_runtime.h>", f'#include "{HEADER}"', s)
    return _sub(r"([\w<>]+)<<<1, 1, 0, s>>>\(", r"emu_launch(\1, 1, 1, 0, ",
                s, literal=False)


def _compile(out_dir, name: str, source: str) -> ctypes.CDLL:
    """g++ `source` into `out_dir` as lib<name>.so (no product fused into a
    sum, as the kernels' --fmad=false) and load it."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the kernel emulator needs g++ (or $CXX)")
    src = os.path.join(str(out_dir), f"{name}.cpp")
    so = os.path.join(str(out_dir), f"lib{name}.so")
    with open(src, "w") as f:
        f.write(source)
    proc = subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off",
                           "-shared", "-fPIC", "-pthread", "-w", "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on the emulated kernel:\n"
                           f"{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(so)


def launch(kernel: str, fn, lib, *args):
    """`fn(lib, *args, None)`, a wrapper's marshalling function, through
    `_build.launch` on the CPU: one launch counted under `kernel`.  Every
    float output the launch allocates starts as NaN, so a word the kernel
    leaves unwritten shows."""
    empty = torch.empty

    def nan_empty(*size, dtype=None, **kw):
        out = empty(*size, dtype=dtype, **kw)
        return out.fill_(float("nan")) if out.is_floating_point() else out

    with mock.patch.object(torch, "empty", nan_empty):
        return _build.launch(kernel, "cpu", fn, lib, *args)


def build(out_dir) -> ctypes.CDLL:
    """Compile the emulated fused kernel into `out_dir` and bind it as
    `ops/_build.bind_fused_corr` binds the card's build."""
    return _build.bind_fused_corr(
        _compile(out_dir, "fused_corr_emulated", emulated_source()))


def fused_ne_emulated(lib, table, hh, scan, mask, pose, nn_radius=1.0,
                      plane_dist_thresh=0.2, robust_weight_floor=0.1,
                      scratch=None, counts=None, floor=False):
    """The kernel's five results (the wrapper's views of its 45 output
    words) on CPU tensors, through the wrapper's `kernel_launch`; `counts`
    as the wrapper takes it (the grid's filled slots a bucket, or None for
    whole rows); `floor` launches the fixed chain alone (uncounted: it is
    no launch of the kernel).  `scratch`, where given, is the zeroed
    scratch buffer to launch with (the ticket must be back at 0
    afterwards)."""
    from lio_slam_tpu_torch.ops import fused_corr as fc

    table, hh, scan, pose = (x.contiguous() for x in (table, hh, scan, pose))
    mask = mask.to(torch.bool).contiguous()
    if scratch is None:
        scratch = torch.zeros(lib.lio_fused_corr_scratch_floats())
    if counts is not None:
        counts = counts.to(torch.int32).contiguous()
    if not floor:
        return fc._views(launch(
            "fused_corr", fc.kernel_launch, lib, table, hh, scan, mask, pose,
            nn_radius, plane_dist_thresh, robust_weight_floor, counts,
            scratch))
    out = torch.full((fc.OUT_WORDS,), float("nan"))
    err = lib.lio_fused_corr_floor(
        *fc._kernel_args(table, hh, scan, mask, pose, nn_radius,
                         plane_dist_thresh, robust_weight_floor, counts),
        scratch.data_ptr(), scratch.numel(), out.data_ptr(), None)
    if err != 0:
        raise RuntimeError(f"emulated launch refused: {err}")
    return fc._views(out)


def build_gn_small(out_dir) -> ctypes.CDLL:
    """Compile the emulated GN-step kernel into `out_dir` and bind it as
    `ops/_build.bind_gn_small` binds the card's build."""
    return _build.bind_gn_small(
        _compile(out_dir, "gn_small_emulated", one_thread_source(GN_SOURCE)))


def gn_small_emulated(lib, AtA, Atb, eigh: bool):
    """The kernel's results on CPU tensors as the wrapper returns them, through
    its `kernel_launch`: dx, and with `eigh` (dx, eigenvalues, eigenvectors as
    columns)."""
    from lio_slam_tpu_torch.ops import gn_small as gs

    out = launch("gn_small_eigh" if eigh else "gn_small", gs.kernel_launch,
                 lib, AtA.to(torch.float32), Atb.to(torch.float32), eigh)
    if not eigh:
        return out
    return out[:6], out[6:12], out[12:].view(6, 6)


def window_system_source() -> str:
    """window_system.cu with the substitutions that make it a CPU program."""
    s = open(WS_SOURCE).read()
    s = _sub("#include <cuda_runtime.h>", f'#include "{HEADER}"', s)
    return _sub("window_system<<<W, THREADS, 0, s>>>(",
                "emu_launch(window_system, W, THREADS, 0, ", s)


def build_window_system(out_dir) -> ctypes.CDLL:
    """Compile the emulated window-system kernel into `out_dir` and bind it
    as `ops/_build.bind_window_system` binds the card's build."""
    return _build.bind_window_system(
        _compile(out_dir, "window_system_emulated", window_system_source()))


def window_system_emulated(lib, graph, count, window: int):
    """The kernel's (H (6W, 6W), b (6W,)) of a CPU `PoseGraph` (the
    wrapper's dtypes) at `count` keyframes, through the wrapper's
    `kernel_launch`."""
    from lio_slam_tpu_torch.ops import window_system as ws

    count = torch.as_tensor(count, dtype=torch.int32).reshape(())
    return launch("window_system", ws.kernel_launch, lib, graph, count, window)


def imu_frontend_source() -> str:
    """imu_frontend.cu with the substitutions that make it a CPU program."""
    s = open(IMU_SOURCE).read()
    s = _sub("#include <cuda_runtime.h>", f'#include "{HEADER}"', s)
    return _sub(r"(\w+)<<<(\w+), THREADS, 0, s>>>\(",
                r"emu_launch(\1, \2, THREADS, 0, ", s, literal=False)


def build_imu_frontend(out_dir) -> ctypes.CDLL:
    """Compile the emulated front-end kernels into `out_dir` and bind them
    as `ops/_build.bind_imu_frontend` binds the card's build; `launch` them
    with `ops/imu_frontend`'s `correct_launch`, `predict_launch` and
    `fusion_launch`."""
    return _build.bind_imu_frontend(
        _compile(out_dir, "imu_frontend_emulated", imu_frontend_source()))


def build_pose_update(out_dir) -> ctypes.CDLL:
    """Compile the emulated pose-tail kernels into `out_dir` and bind them
    as `ops/_build.bind_pose_update` binds the card's build; `launch` them
    with `ops/pose_update`'s `update_launch` and `between_launch`."""
    return _build.bind_pose_update(
        _compile(out_dir, "pose_update_emulated",
                 one_thread_source(POSE_SOURCE)))
