"""The port's native host runtime (`lio_slam_tpu_torch/io/native.py` over
its own copy of `native/liorf_runtime.cpp`, built with g++ into build/ at
first use): the cases of tests/test_native_runtime.py, the copy against the
JAX package's source, and its sample queue against the JAX package's
pure-python twin on a hostile stream."""

import os

import numpy as np
import pytest

import torch_port_helpers as H  # noqa: F401  (single-threaded torch)
from lio_slam_tpu.pipeline.live import _PySampleQueue as JaxPySampleQueue
from lio_slam_tpu_torch.io import native
from lio_slam_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestRingBuffer:
    def test_fifo(self):
        rb = native.RingBuffer(8, 4)
        rb.push(b"aaaaaaaa")
        rb.push(b"bbbbbbbb")
        assert len(rb) == 2
        assert rb.pop() == b"aaaaaaaa"
        assert rb.pop() == b"bbbbbbbb"
        assert rb.pop() is None

    def test_overwrite_drops_oldest(self):
        rb = native.RingBuffer(1, 4)
        for i in range(7):
            rb.push(bytes([i]))
        assert len(rb) == 4
        assert rb.pop()[0] == 3   # 0..2 dropped

    def test_bounded_reject(self):
        rb = native.RingBuffer(1, 2)
        assert rb.push(b"a", overwrite=False)
        assert rb.push(b"b", overwrite=False)
        assert not rb.push(b"c", overwrite=False)
        with pytest.raises(ValueError, match="1 bytes"):
            rb.push(b"ab")


class TestSampleQueue:
    def test_window_and_stale_pop(self):
        q = native.SampleQueue(3, capacity=128)
        for i in range(50):
            q.push(i * 0.01, np.array([i, 2 * i, 3 * i], np.float32))
        ts, vals = q.window(0.2, 0.3, margin=0.02)
        # the window keeps margin samples before t0 (deskew needs a
        # bracketing sample before scan start, imageProjection.cpp:365-369)
        assert ts[0] == pytest.approx(0.19)
        assert ts[-1] == pytest.approx(0.30)
        np.testing.assert_allclose(vals[0], [19, 38, 57])
        # samples strictly older than t0 - margin were permanently dropped
        assert len(q) == 50 - 19

    def test_overflow_compacts(self):
        q = native.SampleQueue(1, capacity=16)
        for i in range(100):
            q.push(float(i), np.array([i], np.float32))
        assert len(q) <= 16
        ts, vals = q.window(95.0, 99.0, margin=0)
        assert list(ts) == [95, 96, 97, 98, 99]
        with pytest.raises(ValueError, match="1 floats"):
            q.push(100.0, np.zeros(2, np.float32))


class TestHostOps:
    def test_voxel_downsample_merges(self):
        a = np.random.RandomState(0).rand(100, 3).astype(np.float32) * 0.1
        b = a + 10.0
        out = native.host_voxel_downsample(np.concatenate([a, b]), 1.0)
        assert out.shape[0] == 2

    def test_pcd_fast_path_matches_python_reader(self, tmp_path):
        from lio_slam_tpu_torch.io import pcd as pcd_io
        xyz = np.random.RandomState(1).randn(256, 3).astype(np.float32)
        p = str(tmp_path / "fast.pcd")
        assert native.pcd_write_binary(p, xyz, np.arange(256, dtype=np.float32))
        x2, attrs = pcd_io.load_pcd(p)
        np.testing.assert_allclose(x2, xyz, atol=0)
        np.testing.assert_allclose(attrs["intensity"], np.arange(256), atol=0)


def test_runtime_source_is_the_jax_packages():
    """The port's C++ copy differs from native/liorf_runtime.cpp only in its
    opening comment; the library is built from it into build/, named by its
    hash."""
    def body(path):
        src = open(path).read()
        return src[src.index("#include"):]

    port = os.path.join(ROOT, "lio_slam_tpu_torch", "io", "csrc",
                        "liorf_runtime.cpp")
    assert body(port) == body(os.path.join(ROOT, "native", "liorf_runtime.cpp"))
    lib = native.load()
    assert os.path.dirname(lib._name) == str(_build.BUILD_DIR)
    assert os.path.basename(lib._name).startswith("libliorf_runtime_")


def hostile_stream(seed=0, n=600):
    """IMU-rate stamps at epoch magnitude with local reordering (writes
    jittered by up to 5 ms), every 7th sample duplicated, and 10-dim
    records."""
    rs = np.random.RandomState(seed)
    ts = 1.7e9 + np.arange(n) * 0.01
    vals = rs.randn(n, 10).astype(np.float32)
    order = np.argsort(ts + rs.uniform(-0.005, 0.005, n) * 2.5)
    out = []
    for k, i in enumerate(order):
        out.append((ts[i], vals[i]))
        if k % 7 == 6:
            out.append((ts[i], vals[i]))
    return out


def replay_stream(queues, stream):
    """Push `stream` into every queue, and every 50 samples take three
    windows (stale pops with and without a margin, one reaching back past
    what was popped); returns each queue's windows and sizes."""
    out = [[] for _ in queues]
    t_last = stream[0][0]
    for k, (t, v) in enumerate(stream):
        for q in queues:
            q.push(t, v)
        if k % 50 == 49:
            for t0, t1, margin in ((t_last - 0.1, t_last + 0.2, 0.0),
                                   (t_last, t_last + 0.5, 0.01),
                                   (t_last - 5.0, t_last + 0.3, 0.0)):
                for q, o in zip(queues, out):
                    ts, vals = q.window(t0, t1, margin=margin, max_n=64)
                    o.append((ts, vals.reshape(-1, 10), len(q)))
            t_last = t
    return out


def assert_same_windows(a, b):
    assert len(a) == len(b) > 0
    for (ta, va, na), (tb, vb, nb) in zip(a, b):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(va, vb)
        assert na == nb


def test_native_queue_matches_jax_python_twin_on_a_hostile_stream():
    """Sorted insert, duplicate drop and stale pops on a stream with
    reordering and duplicates: the same windows and sizes as the JAX
    package's `_PySampleQueue`, while the queue is below its capacity."""
    a, b = replay_stream([native.SampleQueue(10, 4096),
                          JaxPySampleQueue(10, 4096)], hostile_stream())
    assert_same_windows(a, b)
    assert max(n for _, _, n in a) > 40


def test_full_native_queue_matches_jax_native_queue():
    """At capacity the C++ queue drops its oldest sample before the
    duplicate check and the sorted insert, and the python twin after: on
    this stream the two part, in both packages (ROADMAP queue 3).  The
    port's queue gives the JAX package's native queue's windows."""
    from lio_slam_tpu.io import native as jnative

    if not os.path.exists(jnative._LIB_PATH):
        pytest.skip("the JAX package's native library is not built")
    stream = hostile_stream()
    port, jax_native, twin = replay_stream(
        [native.SampleQueue(10, 40), jnative.SampleQueue(10, 40),
         JaxPySampleQueue(10, 40)], stream)
    assert_same_windows(port, jax_native)
    assert any(len(x[0]) != len(y[0]) for x, y in zip(port, twin))
