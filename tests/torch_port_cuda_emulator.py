"""The CUDA kernels `lio_slam_tpu_torch/ops/csrc/fused_corr.cu`,
`gn_small.cu` and `window_system.cu` compiled for the CPU against
`tests/cuda_emulator.h` (g++, C++20) and bound through ctypes, so that the
CPU tests hold the kernels' own source, their control flow and arithmetic,
to the plain versions.  The sources are taken as they are, with mechanical
substitutions: the CUDA runtime header for the emulator's, and each launch
for `emu_launch`; in `fused_corr.cu` also the dynamic shared array for the
emulator's buffer and the three cp.async helpers' bodies for plain copies.
A substitution that no longer matches raises.

    lib = build(tmp_dir)
    out = fused_ne_emulated(lib, table, hh, scan, mask, pose, counts=None, **kw)
    gn = build_gn_small(tmp_dir)
    out = gn_small_emulated(gn, AtA, Atb, eigh=True)
    ws = build_window_system(tmp_dir)
    H, b = window_system_emulated(ws, graph, count, window)
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "lio_slam_tpu_torch", "ops", "csrc",
                      "fused_corr.cu")
GN_SOURCE = os.path.join(ROOT, "lio_slam_tpu_torch", "ops", "csrc",
                         "gn_small.cu")
WS_SOURCE = os.path.join(ROOT, "lio_slam_tpu_torch", "ops", "csrc",
                         "window_system.cu")
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


def gn_small_source() -> str:
    """gn_small.cu with the substitutions that make it a CPU program."""
    s = open(GN_SOURCE).read()
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


def build(out_dir) -> ctypes.CDLL:
    """Compile the emulated fused kernel into `out_dir` and bind it."""
    lib = _compile(out_dir, "fused_corr_emulated", emulated_source())
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.lio_fused_corr, lib.lio_fused_corr_floor):
        fn.argtypes = [vp, ci, ci, vp, ci, vp, vp, vp, ci, vp,
                       cf, cf, cf, vp, ci, vp, vp]
        fn.restype = ci
    lib.lio_fused_corr_scratch_floats.argtypes = []
    lib.lio_fused_corr_scratch_floats.restype = ci
    lib.lio_fused_corr_block_warps.argtypes = [ci, ci]
    lib.lio_fused_corr_block_warps.restype = ci
    return lib


def fused_ne_emulated(lib, table, hh, scan, mask, pose, nn_radius=1.0,
                      plane_dist_thresh=0.2, robust_weight_floor=0.1,
                      scratch=None, counts=None, floor=False):
    """The kernel's five results (the wrapper's views of its 45 output
    words) on CPU tensors, through the emulated launcher; `counts` as the
    wrapper takes it (the grid's filled slots a bucket, or None for whole
    rows); `floor` launches the fixed chain alone.  `scratch`, where given,
    is the zeroed scratch buffer to launch with (the ticket must be back at
    0 afterwards)."""
    from lio_slam_tpu_torch.ops import fused_corr as fc

    table, hh, scan, pose = (x.contiguous() for x in (table, hh, scan, pose))
    mask8 = mask.to(torch.uint8).contiguous()
    if scratch is None:
        scratch = torch.zeros(lib.lio_fused_corr_scratch_floats())
    out = torch.zeros(fc.OUT_WORDS)
    T, C, _ = table.shape
    O, N = hh.shape
    if counts is not None:
        counts = counts.to(torch.int32).contiguous()
    launch = lib.lio_fused_corr_floor if floor else lib.lio_fused_corr
    err = launch(
        table.data_ptr(), T, C, hh.data_ptr(), O,
        None if counts is None else counts.data_ptr(), scan.data_ptr(),
        mask8.data_ptr(), N, pose.data_ptr(), nn_radius, plane_dist_thresh,
        robust_weight_floor, scratch.data_ptr(), scratch.numel(),
        out.data_ptr(), None)
    if err != 0:
        raise RuntimeError(f"emulated launch refused: {err}")
    return fc._views(out)


def build_gn_small(out_dir) -> ctypes.CDLL:
    """Compile the emulated GN-step kernel into `out_dir` and bind it as
    `ops/_build.bind_gn_small` binds the card's build."""
    from lio_slam_tpu_torch.ops import _build

    return _build.bind_gn_small(
        _compile(out_dir, "gn_small_emulated", gn_small_source()))


def gn_small_emulated(lib, AtA, Atb, eigh: bool):
    """The kernel's results on CPU tensors as the wrapper returns them: dx,
    and with `eigh` (dx, eigenvalues, eigenvectors as columns)."""
    from lio_slam_tpu_torch.ops import gn_small as gs

    AtA = AtA.to(torch.float32).contiguous()
    Atb = Atb.to(torch.float32).contiguous()
    out = torch.full((gs.OUT_WORDS[eigh],), float("nan"))
    err = lib.lio_gn_small(AtA.data_ptr(), Atb.data_ptr(), int(eigh),
                           out.data_ptr(), None)
    if err != 0:
        raise RuntimeError(f"emulated launch refused: {err}")
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
    from lio_slam_tpu_torch.ops import _build

    return _build.bind_window_system(
        _compile(out_dir, "window_system_emulated", window_system_source()))


def window_system_emulated(lib, graph, count, window: int):
    """The kernel's (H (6W, 6W), b (6W,)) of a CPU `PoseGraph` (the
    wrapper's dtypes) at `count` keyframes, through the emulated launcher;
    the outputs start as NaN, so a word the kernel leaves unwritten shows."""
    from lio_slam_tpu_torch.graph import factors as F

    g = F.PoseGraph(*(x.contiguous() for x in graph))
    count = torch.as_tensor(count, dtype=torch.int32).reshape(())
    W = window
    H = torch.full((6 * W, 6 * W), float("nan"))
    b = torch.full((6 * W,), float("nan"))
    err = lib.lio_window_system(
        g.poses.data_ptr(), g.poses.shape[0], count.data_ptr(),
        g.prior_pose.data_ptr(), g.prior_info.data_ptr(), g.bt_i.data_ptr(),
        g.bt_j.data_ptr(), g.bt_meas.data_ptr(), g.bt_info.data_ptr(),
        g.bt_mask.data_ptr(), g.bt_i.shape[0], g.gps_i.data_ptr(),
        g.gps_meas.data_ptr(), g.gps_info.data_ptr(), g.gps_mask.data_ptr(),
        g.gps_i.shape[0], W, H.data_ptr(), b.data_ptr(), None)
    if err != 0:
        raise RuntimeError(f"emulated launch refused: {err}")
    return H, b
