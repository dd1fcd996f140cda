"""Scans completed in the window over the time from the window's start to
the last completion in it (host clock); a replay's scans complete with
their chunk."""
from slam_bench import stats

UNIT = "scans/s"


def read(rec):
    return stats.rate(rec["records"], rec["t_start"]) if rec["records"] else None
