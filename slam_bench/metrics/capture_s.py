"""Seconds the resident program's capture took (the `replay.capture`
span: warm-up on a side stream and both graphs captured), set-up before
the window."""
from slam_bench import spans

UNIT = "s"


def read(rec):
    cap = [s for s in spans.recorded() if s.name == "replay.capture"
           and s.t1 is not None and s.t0 < rec["t_start"]]
    return cap[-1].seconds if cap else None
