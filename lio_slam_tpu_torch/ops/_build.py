"""Build the port's native libraries and bind them through ctypes.

- The CUDA kernel library, compiled with nvcc from `ops/csrc/*.cu`: the
  fused correspondence pass (`fused_corr.cu`), the GN step's 6x6
  linear algebra (`gn_small.cu`) and the keyframe save's window system
  (`window_system.cu`).
- The host runtime (SPSC queues, the PCD fast path, a host voxel
  downsample), compiled with g++ from `io/csrc/liorf_runtime.cpp`; it needs
  no CUDA and builds on any machine with a C++17 compiler.

Each is compiled on first use into `build/lio_slam_tpu_torch/` at the
repository root (listed in .gitignore), named by a hash of its sources and
flags, so an edited source rebuilds.  Nothing here runs at import time: the
CPU-only tests import every module.
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
_SOURCES = (_PKG / "csrc" / "fused_corr.cu", _PKG / "csrc" / "gn_small.cu",
            _PKG / "csrc" / "window_system.cu")
_HOST_SOURCES = (_PKG.parent / "io" / "csrc" / "liorf_runtime.cpp",)
BUILD_DIR = _PKG.parents[1] / "build" / "lio_slam_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib = None
_host_lib = None
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


def _digest(flags, sources) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(compiler: str, flags, sources, so: Path) -> tuple:
    """Compile `sources` into `so` (through a temporary name, which keeps
    concurrent builders apart); returns (seconds, compiler output)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed "
                           f"({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, so)
    return seconds, log


def load_fused_corr() -> ctypes.CDLL:
    """Return the kernel library, compiling it if these sources have no build.
    BUILD_SECONDS and BUILD_LOG describe the compile this call made."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    if _lib is not None:
        return _lib
    so = BUILD_DIR / f"liblio_kernels_{_digest(NVCC_FLAGS, _SOURCES)}.so"
    if not so.exists():
        BUILD_SECONDS, BUILD_LOG = _compile(_nvcc(), NVCC_FLAGS, _SOURCES, so)
    _lib = bind_window_system(
        bind_gn_small(bind_fused_corr(ctypes.CDLL(str(so)))))
    return _lib


def bind_fused_corr(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the functions of a build of `ops/csrc/fused_corr.cu` on
    `lib`; returns `lib`."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # table, T, C, hh, O, counts, scan, mask, N, pose6, three thresholds,
    # then scratch, scratch_floats, out, stream; the floor (the launch's
    # fixed chain alone) takes the same
    for fn in (lib.lio_fused_corr, lib.lio_fused_corr_floor):
        fn.argtypes = [vp, ci, ci, vp, ci, vp, vp, vp, ci, vp,
                       cf, cf, cf, vp, ci, vp, vp]
        fn.restype = ci
    lib.lio_fused_corr_scratch_floats.argtypes = []
    lib.lio_fused_corr_scratch_floats.restype = ci
    lib.lio_fused_corr_block_warps.argtypes = [ci, ci]
    lib.lio_fused_corr_block_warps.restype = ci
    return lib


def bind_gn_small(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the functions of a build of `ops/csrc/gn_small.cu` on `lib`;
    returns `lib`."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lio_gn_small.argtypes = [vp, vp, ci, vp, vp]   # AtA, Atb, eigh, out,
    lib.lio_gn_small.restype = ci                      # stream
    # the launch floor, which chip_smoke.py times: AtA, Atb, out, stream
    lib.lio_gn_small_floor.argtypes = [vp, vp, vp, vp]
    lib.lio_gn_small_floor.restype = ci
    return lib


def bind_window_system(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the functions of a build of `ops/csrc/window_system.cu` on
    `lib`; returns `lib`."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # poses, K, count, prior_pose, prior_info, bt_i, bt_j, bt_meas, bt_info,
    # bt_mask, B, gps_i, gps_meas, gps_info, gps_mask, G, W, H, b, stream
    lib.lio_window_system.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, vp,
                                      vp, ci, vp, vp, vp, vp, ci, ci, vp, vp,
                                      vp]
    lib.lio_window_system.restype = ci
    return lib


def load_host_runtime() -> ctypes.CDLL:
    """Return the host runtime library (`io/csrc/liorf_runtime.cpp`),
    compiling it with g++ (or $CXX) if this source has no build; raises
    RuntimeError when the compiler is missing or fails.  `io/native.py`
    declares its functions."""
    global _host_lib
    if _host_lib is not None:
        return _host_lib
    so = BUILD_DIR / f"libliorf_runtime_{_digest(HOST_FLAGS, _HOST_SOURCES)}.so"
    if not so.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if not cxx:
            raise RuntimeError("g++ not found: the host runtime needs a C++17 "
                               "compiler (set CXX or put g++ on PATH)")
        _compile(cxx, HOST_FLAGS, _HOST_SOURCES, so)
    _host_lib = ctypes.CDLL(str(so))
    return _host_lib
