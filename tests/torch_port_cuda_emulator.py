"""The CUDA kernel `lio_slam_tpu_torch/ops/csrc/fused_corr.cu` compiled for
the CPU against `tests/cuda_emulator.h` (g++, C++20) and bound through
ctypes, so that the CPU tests hold the kernel's own source, its control
flow and arithmetic, to the plain version.  The source is taken as it is,
with four mechanical substitutions: the CUDA runtime header for the
emulator's, the dynamic shared array for the emulator's buffer, the three
cp.async helpers' bodies for plain copies, and the launch for
`emu_launch`.  A substitution that no longer matches raises.

    lib = build(tmp_dir)
    out = fused_ne_emulated(lib, table, hh, scan, mask, pose, **kw)
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


def build(out_dir) -> ctypes.CDLL:
    """Compile the emulated kernel into `out_dir` and bind it."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the kernel emulator needs g++ (or $CXX)")
    src = os.path.join(str(out_dir), "fused_corr_emulated.cpp")
    so = os.path.join(str(out_dir), "libfused_corr_emulated.so")
    with open(src, "w") as f:
        f.write(emulated_source())
    proc = subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                           "-pthread", "-w", "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on the emulated kernel:\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lio_fused_corr.argtypes = [vp, ci, ci, vp, ci, vp, vp, ci, vp,
                                   cf, cf, cf, vp, ci, vp, vp]
    lib.lio_fused_corr.restype = ci
    lib.lio_fused_corr_scratch_floats.argtypes = []
    lib.lio_fused_corr_scratch_floats.restype = ci
    lib.lio_fused_corr_block_warps.argtypes = [ci, ci]
    lib.lio_fused_corr_block_warps.restype = ci
    return lib


def fused_ne_emulated(lib, table, hh, scan, mask, pose, nn_radius=1.0,
                      plane_dist_thresh=0.2, robust_weight_floor=0.1,
                      scratch=None):
    """The kernel's five results (the wrapper's views of its 45 output
    words) on CPU tensors, through the emulated launcher.  `scratch`, where
    given, is the zeroed scratch buffer to launch with (the ticket must be
    back at 0 afterwards)."""
    from lio_slam_tpu_torch.ops import fused_corr as fc

    table, hh, scan, pose = (x.contiguous() for x in (table, hh, scan, pose))
    mask8 = mask.to(torch.uint8).contiguous()
    if scratch is None:
        scratch = torch.zeros(lib.lio_fused_corr_scratch_floats())
    out = torch.zeros(fc.OUT_WORDS)
    T, C, _ = table.shape
    O, N = hh.shape
    err = lib.lio_fused_corr(
        table.data_ptr(), T, C, hh.data_ptr(), O, scan.data_ptr(),
        mask8.data_ptr(), N, pose.data_ptr(), nn_radius, plane_dist_thresh,
        robust_weight_floor, scratch.data_ptr(), scratch.numel(),
        out.data_ptr(), None)
    if err != 0:
        raise RuntimeError(f"emulated launch refused: {err}")
    return fc._views(out)
