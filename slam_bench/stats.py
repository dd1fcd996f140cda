"""Arithmetic shared by the metric readers: a window's rate, a
percentile over every scan, and the scans of the window."""

from __future__ import annotations

import statistics


def rate(records: list, t_start: float) -> float:
    """Scans completed in the window over the time from its start to the
    last completion in it."""
    return len(records) / (max(r[2] for r in records) - t_start)


def percentile(values: list, q: int) -> float:
    """The q-th percentile (1..99) of every value, interpolated between
    order statistics."""
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def latencies(records: list) -> list:
    """Each scan's seconds from its hand-in to its completion."""
    return [done - handed for _, handed, done in records]


def window_scans(rec: dict) -> list:
    return [i for i, _, _ in rec["records"]]


def stage_delta(rec: dict, stage: str) -> float:
    """Seconds a Runner stage took over the window."""
    return rec["counters1"].get(stage, 0.0) - rec["counters0"].get(stage, 0.0)
