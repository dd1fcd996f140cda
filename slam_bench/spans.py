"""The program's spans, as the per-layer readers take them.

Importing this module turns the program's span recorder on
(`lio_slam_tpu_torch.utils.profiling.TRACER.enable()`).  The harness
loads the per-layer metric modules, which import it, only for
`--trace 1`, and before it builds the program: the recorder is on in
traced runs alone, from the program's construction on.  A program
without the recorder gives every reader nothing, and each returns None.

A device reader takes the spans of the measured window: those whose host
start lies in [`rec["t_start"]`, the last completion] and that did not
begin under the torch profiler (the profiled slices run slower).  A host
reader of the Runner's spans also takes the warm-up's last cadence
(`loop_every` scans, run after the first cadence has built every shape):
a traced run's window holds few scans outside the profiler, because
reading the slices takes most of `--seconds` (3 of a stream window's 14
scans on an H100), too few to hold a keyframe save.
"""

from __future__ import annotations

from collections import defaultdict

try:
    from lio_slam_tpu_torch.utils.profiling import TRACER
except ImportError:
    TRACER = None
else:
    TRACER.enable()


def recorded() -> list:
    """Every span the program recorded, device marks resolved."""
    return TRACER.read() if TRACER is not None else []


def window(rec: dict, name: str) -> list:
    """The closed spans named `name` of the window, outside the profiler."""
    if not rec["records"]:
        return []
    t_end = max(done for _, _, done in rec["records"])
    return [s for s in recorded() if s.name == name and s.t1 is not None
            and not s.profiled and rec["t_start"] <= s.t0 <= t_end]


def runner_scans(rec: dict, name: str) -> list:
    """The closed spans named `name` outside the profiler of the Runner's
    scans from the warm-up's last cadence to the window's last scan (a
    Runner span's scan id is its scan's index, as a record's is)."""
    if not rec["records"]:
        return []
    first = min(i for i, _, _ in rec["records"]) - rec["traffic"].get("loop_every", 1)
    t_end = max(done for _, _, done in rec["records"])
    return [s for s in recorded() if s.name == name and s.t1 is not None
            and not s.profiled and s.scan is not None and s.scan >= first
            and s.t0 <= t_end]


def mean_ms(spans: list):
    """Mean host ms of the spans, None without one."""
    if not spans:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / len(spans)


def chunks(rec: dict) -> list:
    """Each resident chunk (`replay.chunk`) of the run, oldest first:
    (whether it is in the window, its device-marked `replay.scan` spans by
    start)."""
    spans = recorded()
    inside = {s.id for s in window(rec, "replay.chunk")}
    scans = defaultdict(list)
    for s in spans:
        if s.name == "replay.scan" and s.d0 is not None:
            scans[s.parent].append(s)
    return [(c.id in inside, sorted(scans[c.id], key=lambda s: s.t0))
            for c in spans if c.name == "replay.chunk"]
