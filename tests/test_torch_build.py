"""The launch seam of the port's CUDA kernels (`lio_slam_tpu_torch/ops/
_build.launch`, `LAUNCHES`, `CAPTURED`) on the CPU, with fake launchers:
what it counts, what it refuses, and the counts the benchmark and the
resident replay read from it.  The card's own launches are held in
tests/test_torch_cuda.py."""

import collections
import os
import re
import types

import pytest

from lio_slam_tpu_torch.ops import _build
from lio_slam_tpu_torch.ops import fused_corr
from lio_slam_tpu_torch.pipeline import replay

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def counters():
    """Each test starts from the counters as they were and leaves them so."""
    held = _build.LAUNCHES.copy(), _build.CAPTURED.copy()
    yield
    for counter, was in zip((_build.LAUNCHES, _build.CAPTURED), held):
        counter.clear()
        counter.update(was)


def test_a_launch_counts_once_under_its_key():
    """`launch` calls the launcher with its arguments and no stream on the
    CPU, returns its results and counts one launch under the key, outside
    any capture."""
    calls = []

    def launcher(lib, x, stream):
        calls.append((lib, x, stream))
        return 0, ("out", x)

    before = _build.LAUNCHES.copy(), _build.CAPTURED.copy()
    out = _build.launch("fake_kernel", "cpu", launcher, "lib", 7)
    assert out == ("out", 7)
    assert calls == [("lib", 7, None)]
    assert _build.LAUNCHES - before[0] == {"fake_kernel": 1}
    assert _build.CAPTURED == before[1]


def test_a_refused_launch_raises_and_counts_nothing():
    """A nonzero cudaError_t raises RuntimeError naming the kernel and the
    code, and counts nothing anywhere."""
    before = _build.LAUNCHES.copy(), _build.CAPTURED.copy()
    with pytest.raises(RuntimeError, match=r"fake_kernel.*cudaError_t 9"):
        _build.launch("fake_kernel", "cpu", lambda stream: (9, None))
    assert (_build.LAUNCHES, _build.CAPTURED) == before


def test_fused_corr_kernel_launches_reads_the_seam():
    """The benchmark's `fused_corr.KERNEL_LAUNCHES` is the seam's
    "fused_corr" count, replays included, and the module holds no other."""
    _build.LAUNCHES["fused_corr"] += 3
    assert fused_corr.KERNEL_LAUNCHES == _build.LAUNCHES["fused_corr"]
    _build.launch("fused_corr", "cpu", lambda stream: (0, None))
    assert fused_corr.KERNEL_LAUNCHES == _build.LAUNCHES["fused_corr"]
    assert "KERNEL_LAUNCHES" not in vars(fused_corr)
    with pytest.raises(AttributeError):
        fused_corr.LAUNCHES


def test_nothing_assigns_the_benchmarks_count():
    """A module attribute assigned anywhere would shadow
    `fused_corr.__getattr__`: no source of the repo assigns
    KERNEL_LAUNCHES."""
    assign = re.compile(r"KERNEL_LAUNCHES\s*(\+|-)?=[^=]")
    found = []
    for top in ("lio_slam_tpu_torch", "slam_bench", "tests", "tools"):
        for base, _, files in os.walk(os.path.join(ROOT, top)):
            found += [os.path.join(base, f) for f in files
                      if f.endswith(".py") and assign.search(
                          open(os.path.join(base, f)).read())]
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        if assign.search(f.read()):
            found.append("chip_smoke.py")
    assert found == []


def test_a_graph_replay_adds_what_the_graph_holds():
    """`_ScanProgram._replay(k)` replays graph k and adds the launches its
    capture recorded, by key, to `LAUNCHES`."""
    replayed = []
    graph = lambda k: types.SimpleNamespace(replay=lambda: replayed.append(k))
    held = (collections.Counter(fused_corr=30, gn_small=29, gn_small_eigh=1,
                                window_system=2, imu_predict=1),
            collections.Counter(imu_correct=1, imu_fusion=1))
    program = types.SimpleNamespace(graphs=(graph(0), graph(1)),
                                    launches=held)
    before = _build.LAUNCHES.copy()
    for k in (0, 1, 0):
        replay._ScanProgram._replay(program, k)
    assert replayed == [0, 1, 0]
    assert _build.LAUNCHES - before == held[0] + held[1] + held[0]
