"""The readers of the program's spans (`slam_bench/spans.py` and nine files
of `metrics/`): the right numbers on a synthetic record of spans, None
without spans or without the recorder, and the import of the helper
turning the recorder on.  Each test leaves the recorder as it found it."""

import importlib
import importlib.util
import types

import pytest

from benchtree import BENCH
from lio_slam_tpu_torch.utils import profiling
from lio_slam_tpu_torch.utils.profiling import TRACER

READERS = ("host_ms.register", "host_ms.keyframe_save", "host_ms.window_solve",
           "host_ms.sc_descriptor", "host_ms.map_insert",
           "replay_scan_device_ms", "replay_scan_gap_ms",
           "replay_chunk_gap_ms", "capture_s")


@pytest.fixture
def bench_spans():
    """`slam_bench.spans`, imported here since its first import turns the
    recorder on; the recorder's switch as it was before, and no spans,
    afterwards."""
    was = TRACER.on
    try:
        from slam_bench import spans
        yield spans
    finally:
        TRACER.on = was
        TRACER.clear()


def _metric(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def span(id_, name, t0, t1, parent=None, d=None, profiled=False, scan=None):
    s = profiling.Span(id_, name, parent, scan, profiled)
    s.t0, s.t1 = t0, t1
    if d is not None:
        s.d0, s.d1 = d
    return s


def synthetic_record():
    """A stream-like and a drive-like run in one record: the window is
    [10, 20] and holds scans 20 and 21; with `loop_every` 10 the Runner's
    readers also take scans 10-19 of the warm-up."""
    sp = [span(0, "replay.capture", 1.0, 4.5),
          span(1, "mapping.register", 7.0, 7.5, scan=5),     # early warm-up
          span(2, "mapping.register", 9.0, 9.012, scan=15),  # its last cadence
          span(3, "mapping.register", 10.0, 10.004, scan=20),
          span(4, "mapping.register", 11.0, 11.008, scan=21),
          span(5, "mapping.register", 12.0, 12.1, profiled=True, scan=22),
          span(6, "mapping.save", 13.0, 13.03, scan=21),
          span(7, "save.sc_descriptor", 13.001, 13.002, parent=6, scan=21),
          span(8, "save.window_solve", 13.002, 13.022, parent=6, scan=21),
          span(9, "save.map_insert", 13.022, 13.028, parent=6, scan=21),
          span(10, "mapping.register", 21.0, 21.5, scan=40)]  # after it
    # chunks: 11 in the window, 14 in it, 17 profiled, 20 in it; one
    # before the window
    d = {11: [(14.0, 14.010), (14.011, 14.020)],
         14: [(14.030, 14.040), (14.042, 14.050)],
         17: [(14.060, 14.070), (14.071, 14.080)],
         20: [(14.090, 14.100), (14.103, 14.110)],
         23: [(5.0, 5.5), (5.6, 5.9)]}
    for c, marks in d.items():
        prof = c == 17
        t = 14.0 + c / 100 if c != 23 else 5.0
        sp.append(span(c, "replay.chunk", t, t + 0.001, profiled=prof))
        for k, m in enumerate(marks):
            sp.append(span(c + 1 + k, "replay.scan", t + k / 1000,
                           t + k / 1000 + 0.0005, parent=c, d=m,
                           profiled=prof, scan=k))
    sp.sort(key=lambda s: s.t0)
    rec = {"t_start": 10.0, "records": [(20, 10.0, 15.0), (21, 15.0, 20.0)],
           "traffic": {"loop_every": 10}}
    return sp, rec


def test_readers_on_a_synthetic_record(monkeypatch, bench_spans):
    readers = {m: _metric(m) for m in READERS}
    sp, rec = synthetic_record()
    monkeypatch.setattr(bench_spans, "TRACER", types.SimpleNamespace(
        read=lambda: list(sp)))
    got = {m: r.read(rec) for m, r in readers.items()}
    want = {"host_ms.register": 8.0, "host_ms.keyframe_save": 30.0,
            "host_ms.window_solve": 20.0, "host_ms.sc_descriptor": 1.0,
            "host_ms.map_insert": 6.0,
            # 6 window scans: 10, 9, 10, 8, 10, 7 device ms
            "replay_scan_device_ms": 9.0,
            # within a chunk: 1, 2, 3 ms
            "replay_scan_gap_ms": 2.0,
            # 11 -> 14 only: 14 -> 20 has the profiled chunk between,
            # and chunk 23 lies before the window
            "replay_chunk_gap_ms": 10.0,
            "capture_s": 3.5}
    assert set(got) == set(want)
    for m in want:
        assert got[m] == pytest.approx(want[m], rel=1e-6, abs=1e-9), m
    # device window of the in-window chunks = scans + gaps (the identity
    # the drive's readers keep, here with its chunk gap of 10 ms)
    ch = [s for inside, s in bench_spans.chunks(rec) if inside][:2]
    whole = ch[1][-1].d1 - ch[0][0].d0
    parts = sum(s.d1 - s.d0 for c in ch for s in c) + 1e-3 * (1 + 2) \
        + 1e-3 * 10
    assert whole == pytest.approx(parts)


def test_readers_return_none_without_spans(monkeypatch, bench_spans):
    readers = {m: _metric(m) for m in READERS}
    _, rec = synthetic_record()
    monkeypatch.setattr(bench_spans, "TRACER", types.SimpleNamespace(
        read=lambda: []))
    assert {m: r.read(rec) for m, r in readers.items()} == dict.fromkeys(READERS)
    # a program without the recorder
    monkeypatch.setattr(bench_spans, "TRACER", None)
    assert {m: r.read(rec) for m, r in readers.items()} == dict.fromkeys(READERS)
    assert bench_spans.window({"t_start": 0.0, "records": []}, "x") == []


def test_importing_the_helper_turns_the_recorder_on(bench_spans):
    TRACER.disable()
    importlib.reload(bench_spans)
    assert TRACER.on and bench_spans.TRACER is TRACER
