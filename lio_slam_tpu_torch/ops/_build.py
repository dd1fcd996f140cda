"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

The shared library is compiled on first use from `ops/csrc/*.cu` into
`build/lio_slam_tpu_torch/` at the repository root (listed in .gitignore),
named by a hash of the sources and flags, so an edited source rebuilds.
Nothing here runs at import time: the CPU-only tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SOURCES = (_PKG / "csrc" / "fused_corr.cu",)
BUILD_DIR = _PKG.parents[1] / "build" / "lio_slam_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_lib = None
BUILD_SECONDS = None      # wall time of this process's compile (None if cached)
BUILD_LOG = ""            # nvcc's output (ptxas register / spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_fused_corr() -> ctypes.CDLL:
    """Return the kernel library, compiling it if this source has no build.
    BUILD_SECONDS and BUILD_LOG describe the compile this call made."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    if _lib is not None:
        return _lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"liblio_kernels_{_digest()}.so"
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{BUILD_LOG}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # table, T, C, hh, O, scan, mask, N, pose6, three thresholds, then
    # scratch, scratch_floats, out, stream
    lib.lio_fused_corr.argtypes = [vp, ci, ci, vp, ci, vp, vp, ci, vp,
                                   cf, cf, cf, vp, ci, vp, vp]
    lib.lio_fused_corr.restype = ci
    lib.lio_fused_corr_scratch_floats.argtypes = []
    lib.lio_fused_corr_scratch_floats.restype = ci
    _lib = lib
    return lib
