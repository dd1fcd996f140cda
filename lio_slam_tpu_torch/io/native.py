"""ctypes bindings for the native host runtime (the port's copy of
`lio_slam_tpu/io/native.py`, over its own `io/csrc/liorf_runtime.cpp`).

The library is built with g++ on first use into the gitignored
`build/lio_slam_tpu_torch/` (`ops/_build.load_host_runtime`); it is host
code and needs no CUDA.  `pipeline/live._PySampleQueue` is the pure-python
twin of `SampleQueue`, but production feeds should use the native queues
(SPSC rings drain without holding the GIL on the producer side).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from lio_slam_tpu_torch.ops import _build

_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The runtime library with its functions declared; builds it at first
    use and raises RuntimeError where it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load_host_runtime()
    c = ctypes
    lib.rb_create.restype = c.c_void_p
    lib.rb_create.argtypes = [c.c_size_t, c.c_size_t]
    lib.rb_push.restype = c.c_int
    lib.rb_push.argtypes = [c.c_void_p, c.c_void_p]
    lib.rb_push_overwrite.restype = c.c_int
    lib.rb_push_overwrite.argtypes = [c.c_void_p, c.c_void_p]
    lib.rb_pop.restype = c.c_int
    lib.rb_pop.argtypes = [c.c_void_p, c.c_void_p]
    lib.rb_size.restype = c.c_size_t
    lib.rb_size.argtypes = [c.c_void_p]
    lib.rb_destroy.argtypes = [c.c_void_p]
    lib.sq_create.restype = c.c_void_p
    lib.sq_create.argtypes = [c.c_size_t, c.c_size_t]
    lib.sq_push.restype = c.c_int
    lib.sq_push.argtypes = [c.c_void_p, c.c_double, c.POINTER(c.c_float)]
    lib.sq_window.restype = c.c_int
    lib.sq_window.argtypes = [c.c_void_p, c.c_double, c.c_double, c.c_double,
                              c.POINTER(c.c_double), c.POINTER(c.c_float),
                              c.c_int]
    lib.sq_size.restype = c.c_size_t
    lib.sq_size.argtypes = [c.c_void_p]
    lib.sq_destroy.argtypes = [c.c_void_p]
    lib.pcd_write_binary.restype = c.c_int
    lib.pcd_write_binary.argtypes = [c.c_char_p, c.POINTER(c.c_float),
                                     c.POINTER(c.c_float), c.c_long]
    lib.host_voxel_downsample.restype = c.c_long
    lib.host_voxel_downsample.argtypes = [c.POINTER(c.c_float), c.c_long,
                                          c.c_float, c.POINTER(c.c_float),
                                          c.c_long]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the runtime builds and loads here."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


class RingBuffer:
    """SPSC ring of fixed-size byte records (the subscriber-queue role)."""

    def __init__(self, record_size: int, capacity: int):
        self._lib = load()
        self._h = self._lib.rb_create(record_size, capacity)
        self.record_size = record_size

    def push(self, data: bytes, overwrite: bool = True) -> bool:
        if len(data) != self.record_size:
            raise ValueError(f"a record is {self.record_size} bytes, "
                             f"got {len(data)}")
        fn = self._lib.rb_push_overwrite if overwrite else self._lib.rb_push
        return fn(self._h, data) >= 0

    def pop(self) -> Optional[bytes]:
        buf = ctypes.create_string_buffer(self.record_size)
        if self._lib.rb_pop(self._h, buf) != 0:
            return None
        return buf.raw

    def __len__(self) -> int:
        return self._lib.rb_size(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rb_destroy(self._h)
            self._h = None


class SampleQueue:
    """Timestamped float-vector queue with windowed extraction (the IMU/odom
    queue + stale-pop semantics of imageProjection.cpp:359-418)."""

    def __init__(self, dim: int, capacity: int = 4096):
        self._lib = load()
        self.dim = dim
        self._h = self._lib.sq_create(dim, capacity)

    def push(self, t: float, vals) -> None:
        v = np.ascontiguousarray(vals, np.float32)
        if v.size != self.dim:
            raise ValueError(f"a sample holds {self.dim} floats, got {v.size}")
        self._lib.sq_push(self._h, float(t),
                          v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

    def window(self, t0: float, t1: float, margin: float = 0.01,
               max_n: int = 2048):
        ts = np.empty(max_n, np.float64)
        vals = np.empty((max_n, self.dim), np.float32)
        n = self._lib.sq_window(
            self._h, float(t0), float(t1), float(margin),
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_n)
        return ts[:n], vals[:n]

    def __len__(self) -> int:
        return self._lib.sq_size(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sq_destroy(self._h)
            self._h = None


def _points(xyz) -> np.ndarray:
    xyz = np.ascontiguousarray(xyz, np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {xyz.shape}")
    return xyz


def pcd_write_binary(path: str, xyz: np.ndarray,
                     intensity: Optional[np.ndarray] = None) -> bool:
    """Binary PCD fast path; False where the runtime is not available or
    the file cannot be opened."""
    if not available():
        return False
    xyz = _points(xyz)
    inten_ptr = None
    if intensity is not None:
        intensity = np.ascontiguousarray(intensity, np.float32)
        if intensity.shape != (len(xyz),):
            raise ValueError(f"{len(xyz)} points, intensity {intensity.shape}")
        inten_ptr = intensity.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    rc = _lib.pcd_write_binary(
        path.encode(), xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        inten_ptr, xyz.shape[0])
    return rc == 0


def host_voxel_downsample(xyz: np.ndarray, leaf: float,
                          max_out: int = 1 << 20) -> np.ndarray:
    """Centroid per occupied voxel of `leaf` metres, on the host."""
    lib = load()
    xyz = _points(xyz)
    out = np.empty((max_out, 3), np.float32)
    m = lib.host_voxel_downsample(
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), xyz.shape[0],
        float(leaf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_out)
    return out[:m].copy()
