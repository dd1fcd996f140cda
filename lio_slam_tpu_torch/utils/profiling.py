"""Per-stage timing and rate monitoring (port of
`lio_slam_tpu/utils/profiling.py`; the reference's TicToc stopwatch and the
`rostopic hz` health check).

- `StageTimer`: named stages with count, total, max, EMA and the last
  duration, a one-line-a-stage report.  Each stage accumulates its host
  time (the enqueue, plus any device wait inside the stage) and is a
  `torch.profiler.record_function` range, so a profiled run reads each
  stage's device time from the same trace.
- `RateMonitor`: a stream's arrival rate against its expected rate.
- `TRACER`: the port's span recorder (a `Tracer`), off until `enable()`.
  A span holds its name, its parent, a scan id, its host start and end
  and whether the torch profiler was on when it began; a span opened with
  `device=True` also marks its start and end on the device.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

RING = 65536           # spans a tracer keeps; older ones are dropped

STAGES = ("imu_predict", "deskew", "mapping_step", "full_correction",
          "imu_frontend", "loop_closure", "archive_loop", "host_fetch")


@dataclass
class StageStats:
    count: int = 0
    total: float = 0.0
    max: float = 0.0
    ema: float = 0.0
    last_dt: float = 0.0

    def update(self, dt: float, alpha: float = 0.1):
        self.count += 1
        self.total += dt
        self.max = max(self.max, dt)
        self.ema = dt if self.count == 1 else (1 - alpha) * self.ema + alpha * dt
        self.last_dt = dt


class StageTimer:
    def __init__(self):
        self.stats: Dict[str, StageStats] = defaultdict(StageStats)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.stats[name].update(time.perf_counter() - t0)

    def record(self, name: str, dt: float):
        self.stats[name].update(dt)

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stats.items()):
            mean = s.total / max(s.count, 1)
            lines.append(f"{name:>24s}: n={s.count:5d} mean={mean * 1e3:8.2f}ms "
                         f"ema={s.ema * 1e3:8.2f}ms max={s.max * 1e3:8.2f}ms")
        return "\n".join(lines)

    def last(self) -> dict:
        """Most recent duration per stage (seconds): per-step logging."""
        return {k: v.last_dt for k, v in self.stats.items()}

    def as_dict(self) -> dict:
        return {k: {"count": v.count, "mean_ms": v.total / max(v.count, 1) * 1e3,
                    "max_ms": v.max * 1e3}
                for k, v in self.stats.items()}


@dataclass
class RateMonitor:
    """`rostopic hz` equivalent: the arrival rate of a stream, and whether
    it departs from the expected rate (README.md:308-322 records ~10 Hz on
    7 topics as the health check)."""

    expected_hz: float
    tolerance: float = 0.3        # fraction
    window: int = 50
    _stamps: list = field(default_factory=list)

    def tick(self, stamp: Optional[float] = None):
        self._stamps.append(time.time() if stamp is None else stamp)
        if len(self._stamps) > self.window:
            self._stamps.pop(0)

    @property
    def hz(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        span = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / span if span > 0 else 0.0

    @property
    def healthy(self) -> bool:
        if len(self._stamps) < max(3, self.window // 5):
            return True            # not enough data to judge
        return abs(self.hz - self.expected_hz) <= self.tolerance * self.expected_hz


class Span:
    """One recorded span.  `t0` / `t1`: host start and end
    (`time.perf_counter`, seconds; `t1` None while open).  `d0` / `d1`: a
    device span's start and end marks on the same clock, set when the
    tracer is read (None for a host span).  `profiled`: the torch profiler
    was on when it began."""

    __slots__ = ("id", "name", "parent", "scan", "profiled", "t0", "t1",
                 "d0", "d1", "_marks", "_range")

    def __init__(self, id_, name, parent, scan, profiled):
        self.id, self.name, self.parent, self.scan = id_, name, parent, scan
        self.profiled = profiled
        self.t0 = self.t1 = self.d0 = self.d1 = None
        self._marks = self._range = None

    @property
    def seconds(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"scan={self.scan}, t0={self.t0}, t1={self.t1}, d0={self.d0}, "
                f"d1={self.d1}, profiled={self.profiled})")


NO_SPAN = contextlib.nullcontext()     # what a span is where nothing records


class Tracer:
    """Spans kept in memory, in a ring of `capacity` (`dropped` counts
    those it overwrote).  Off, a span is one branch: no record, no CUDA
    event, no profiler range.  On:

    - `span(name)` is a context manager, `begin(name)` / `end(span)` the
      same span opened and closed in two places.  The span open when
      another begins is its parent; `scan` defaults to the parent's, else
      to `self.scan`, which the caller sets (the Runner: its scan count).
    - `device=True`, which a caller passes for work on the card, also
      records a CUDA timing event at the start and at the end, on the
      current stream: no synchronization and no query until `read()`.
    - Inside a profiled region a span is also a `record_function` range,
      so it sits in the device trace beside the kernels it launched.
    - While the current stream is capturing a CUDA graph nothing is
      recorded: a captured span would mark the capture, not the replays.

    `read()` resolves the device marks: it records one anchor event,
    synchronizes, and puts each mark on the host clock as
    t_anchor - elapsed(mark, anchor).  The anchor's host time is taken
    after its synchronize, so the marks may sit late by that round trip.
    One thread, one device."""

    def __init__(self, capacity: int = RING):
        self.on = False
        self.scan = None
        self.dropped = 0
        self._ring = deque(maxlen=capacity)
        self._open = []
        self._next = 0
        self._cuda = False

    def enable(self):
        self.on = True
        self._cuda = torch.cuda.is_available()

    def disable(self):
        self.on = False

    def clear(self):
        """Forget every span (open ones included) and the drop count."""
        self._ring.clear()
        self._open.clear()
        self.dropped = 0

    def span(self, name: str, device: bool = False, scan=None):
        """`with tracer.span(name) as s:`; `s` is the Span, or None where
        nothing is recorded."""
        if not self.on:
            return NO_SPAN
        return self._spanning(name, device, scan)

    @contextlib.contextmanager
    def _spanning(self, name, device, scan):
        s = self.begin(name, device=device, scan=scan)
        try:
            yield s
        finally:
            self.end(s)

    def begin(self, name: str, device: bool = False,
              scan=None) -> Optional[Span]:
        """Open a span; None where nothing is recorded."""
        if not self.on or (self._cuda
                           and torch.cuda.is_current_stream_capturing()):
            return None
        parent = self._open[-1] if self._open else None
        s = Span(self._next, name, None if parent is None else parent.id,
                 scan if scan is not None else
                 (self.scan if parent is None else parent.scan),
                 torch.autograd._profiler_enabled())
        self._next += 1
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
        self._ring.append(s)
        self._open.append(s)
        if s.profiled:
            s._range = torch.profiler.record_function(name)
            s._range.__enter__()
        s.t0 = time.perf_counter()
        if device and self._cuda:
            s._marks = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            s._marks[0].record()
        return s
    def end(self, s: Optional[Span]):
        if s is None:
            return
        if s._marks is not None:
            s._marks[1].record()
        s.t1 = time.perf_counter()
        if s._range is not None:
            s._range.__exit__(None, None, None)
            s._range = None
        if s in self._open:
            self._open.remove(s)

    def read(self) -> list:
        """Every span the ring holds, oldest first, the device marks of
        the closed ones resolved on the host clock."""
        todo = [s for s in self._ring
                if s._marks is not None and s.t1 is not None and s.d0 is None]
        if todo:
            torch.cuda.synchronize()
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record()
            anchor.synchronize()
            t_anchor = time.perf_counter()
            for s in todo:
                s.d0 = t_anchor - 1e-3 * s._marks[0].elapsed_time(anchor)
                s.d1 = t_anchor - 1e-3 * s._marks[1].elapsed_time(anchor)
        return list(self._ring)


TRACER = Tracer()
