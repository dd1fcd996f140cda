"""The port's span recorder (`utils/profiling.TRACER`):

- off, a span records nothing, makes no CUDA event and opens no profiler
  range beyond StageTimer's own;
- on: parents, scan ids, the ring's bound and its drop count, the
  profiler flag, nothing recorded while a graph capture is reported;
- a small Runner mission: `mapping.register` on every scan, `mapping.save`
  and its three children on the keyframe scans only, StageTimer's keys
  as they were and no stage recorded as a span;
- a resident replay chunk on the CPU: `replay.chunk`, one `replay.scan` a
  scan with the resident step's spans inside it, and no device mark even
  where a card is present.

The device marks are checked on the card (`tests/test_torch_cuda.py`);
the benchmark's readers of the spans in `slam_bench/tests/`.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import small_config
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.pipeline import replay
from lio_slam_tpu_torch.pipeline import synthetic_mission as sm
from lio_slam_tpu_torch.pipeline.runner import Runner
from lio_slam_tpu_torch.utils import profiling
from lio_slam_tpu_torch.utils.profiling import TRACER, Tracer

SAVE_PARTS = ("save.sc_descriptor", "save.window_solve", "save.map_insert")


@pytest.fixture
def tracer():
    """The module's TRACER, on and empty; off and empty afterwards."""
    TRACER.clear()
    TRACER.enable()
    try:
        yield TRACER
    finally:
        TRACER.disable()
        TRACER.clear()
        TRACER.scan = None


@pytest.fixture
def counted(monkeypatch):
    """Counts of CUDA events made and profiler ranges opened."""
    n = {"event": 0, "range": 0}

    def event(*a, **k):
        n["event"] += 1
        raise AssertionError("a CUDA event was made")

    ranged = torch.profiler.record_function

    def record_function(*a, **k):
        n["range"] += 1
        return ranged(*a, **k)

    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    return n


def names(spans):
    return [s.name for s in spans]


def chunk_inputs(n_scans):
    """The config of the replay tests and a numpy batch of `n_scans`
    synthetic scans (no JAX imported: this file runs on the card too)."""
    cfg = port_config.Config(
        static=port_config.StaticConfig(
            max_raw_points=2048, max_scan_points=2048, max_map_points=8192,
            max_keyframes=16, max_keyframe_points=1024, max_loop_queue=2,
            max_gps_queue=2, window_size=8, max_imu_window=16),
        registration=port_config.RegistrationConfig(degeneracy_eig_thresh=10.0))
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=0)
    acc, gyr, dts, rel_t, imask = synthetic.make_imu_windows(
        seq, 16, samples_per_scan=8, gravity=cfg.imu.gravity)
    P = cfg.static.max_raw_points
    return cfg, replay.ReplayBatch(
        xyz=seq.scans, ptime=np.zeros((n_scans, P), np.float32),
        pmask=seq.scan_masks, ring=np.zeros((n_scans, P), np.int32),
        acc=acc, gyr=gyr, dts=dts, rel_t=rel_t, imask=imask, stamp=seq.stamps)


def test_off_records_nothing(counted):
    assert not TRACER.on
    timer = profiling.StageTimer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with timer.stage("mapping_step"):
            with TRACER.span("mapping.register", device=True) as s:
                assert s is None
            TRACER.end(TRACER.begin("replay.scan", device=True))
    assert TRACER.read() == [] and TRACER.dropped == 0
    assert counted == {"event": 0, "range": 1}      # the stage's own range
    assert timer.stats["mapping_step"].count == 1


def test_parents_scan_ids_and_split_spans():
    t = Tracer()
    t.enable()
    t.scan = 7
    with t.span("a") as a:
        with t.span("b") as b:
            pass
        c = t.begin("c", scan=3)
        with t.span("d") as d:
            pass
        t.end(c)
    with t.span("e") as e:
        pass
    assert names(t.read()) == ["a", "b", "c", "d", "e"]
    assert [s.id for s in (a, b, c, d, e)] == [0, 1, 2, 3, 4]
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (
        None, a.id, a.id, c.id, None)
    assert (a.scan, b.scan, c.scan, d.scan, e.scan) == (7, 7, 3, 3, 7)
    assert a.t0 <= b.t0 <= b.t1 <= c.t0 <= d.t0 <= d.t1 <= c.t1 <= a.t1 <= e.t0
    assert all(s.d0 is None and s.d1 is None and not s.profiled
               for s in t.read())


def test_ring_bound_and_drop_count():
    t = Tracer(capacity=4)
    t.enable()
    for k in range(10):
        with t.span(f"s{k}"):
            pass
    assert names(t.read()) == ["s6", "s7", "s8", "s9"]
    assert t.dropped == 6
    t.clear()
    assert t.read() == [] and t.dropped == 0


def test_profiler_flag_and_ranges():
    t = Tracer()
    t.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.span("inside"):
            torch.ones(4).sum()
    with t.span("outside"):
        pass
    inside, outside = t.read()
    assert inside.profiled and not outside.profiled
    assert [e.name for e in prof.events()].count("inside") == 1


def test_stage_timer_stages_are_not_spans(tracer):
    timer = profiling.StageTimer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.stage("deskew"):
            with tracer.span("inner"):
                pass
    assert [e.name for e in prof.events()].count("deskew") == 1
    assert names(tracer.read()) == ["inner"]
    assert tracer.read()[0].parent is None
    assert timer.stats["deskew"].count == 1


def test_nothing_recorded_while_capturing(monkeypatch, counted):
    t = Tracer()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    t.enable()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with t.span("captured", device=True) as s:
        assert s is None
    t.end(t.begin("captured", device=True))
    assert t.read() == [] and counted["event"] == 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    with t.span("after"):
        pass
    assert names(t.read()) == ["after"]


def test_runner_mission_spans(tracer):
    n_scans = 6
    cfg = small_config(port_config)
    seq = synthetic.make_sequence(n_scans=n_scans, n_points=2048, seed=0)
    scans, imus = sm.synthetic_inputs(seq, cfg)
    runner = Runner(cfg, device="cpu")
    kf = [runner.process_scan(scans[i], imu=imus[i]).is_keyframe
          for i in range(n_scans)]
    assert 2 <= sum(kf) < n_scans
    spans = tracer.read()
    by_id = {s.id: s for s in spans}
    reg = [s for s in spans if s.name == "mapping.register"]
    assert [s.scan for s in reg] == list(range(n_scans))
    saves = [s for s in spans if s.name == "mapping.save"]
    assert [s.scan for s in saves] == [i for i in range(n_scans) if kf[i]]
    for save in saves:
        parts = [s for s in spans if s.parent == save.id]
        assert names(parts) == list(SAVE_PARTS)
        assert all(save.t0 <= p.t0 <= p.t1 <= save.t1 for p in parts)
        assert all(p.scan == save.scan for p in parts)
    assert len([s for s in spans if s.name in SAVE_PARTS]) == 3 * sum(kf)
    assert all(s.parent is None or by_id[s.parent].name == "mapping.save"
               for s in spans)
    assert {s.name for s in spans} == {"mapping.register", "mapping.save",
                                       *SAVE_PARTS}
    # StageTimer keeps its keys, and no stage is a span
    stats = runner.timer.stats
    assert set(stats) <= set(profiling.STAGES) and "mapping_step" in stats
    assert stats["mapping_step"].count == n_scans


def test_resident_chunk_spans(tracer, monkeypatch, counted):
    """The CPU program marks nothing on the device even where a card is
    present: its device marks follow the program's device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    tracer.enable()
    cfg, batch = chunk_inputs(2)
    chunk = replay.make_pipeline_replay_carry(cfg, device="cpu")
    state, fes = chunk.replay.init()
    chunk(state, fes, torch.zeros(6), batch)
    spans = tracer.read()
    assert counted["event"] == 0
    run = spans[0]
    assert run.name == "replay.chunk" and run.parent is None
    scans = [s for s in spans if s.name == "replay.scan"]
    assert [(s.parent, s.scan) for s in scans] == [(run.id, 0), (run.id, 1)]
    assert run.t0 <= scans[0].t0 <= scans[0].t1 <= scans[1].t0 \
        <= scans[1].t1 <= run.t1
    assert all(s.d0 is None and s.d1 is None for s in spans)
    # the resident step runs eagerly here, so its spans sit in the scan's
    by_id = {s.id: s for s in spans}
    for s in spans[1:]:
        assert s.name == "replay.scan" or s.name in (
            "mapping.register", *SAVE_PARTS), s
        top = s
        while by_id[top.parent].name != "replay.chunk":
            top = by_id[top.parent]
        assert top.name == "replay.scan" and s.scan == top.scan
    assert [s.scan for s in spans if s.name == "mapping.register"] == [0, 1]
    assert chunk.replay.capture_seconds is None
