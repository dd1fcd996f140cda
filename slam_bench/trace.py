"""The traced run's readings: a profiled slice of the window (device busy
time, kernels and copies, what the device ran longest, the longest idle
gaps by what the host was doing) and the fused kernel's launches with the
operands its bound needs.

torch.profiler drops device records late in a long process, so a slice is
taken early in the window, and one whose fused-kernel records fall short
of the launches the program counted is taken again (the share kept is
part of the reading).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

KEPT_ENOUGH = 0.95          # share of the kernel's launches a slice must keep
SLICE_TRIES = 3
KERNEL = "fused_corr_groups" # the fused kernel's name in the trace


def warm_profiler(device):
    """The tracer reports nothing from the first profile of a process:
    spend that one on a throwaway."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1024, device=device)
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for _ in range(10):
                x = x + 1.0
            torch.cuda.synchronize()


def _device_rows(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]


def _idle_gaps(prof, labels: set) -> list:
    """[[host activity, seconds]]: the gaps between device operations,
    summed by the innermost labelled host range open when each began."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == cuda and not getattr(e, "is_user_annotation", False):
            dev.append((tr.start, tr.end))
        elif e.name in labels:
            host.append((tr.start, tr.end, e.name))
    dev.sort()
    host.sort()
    starts = [h[0] for h in host]
    by = defaultdict(float)
    end = dev[0][1] if dev else 0
    for s, e in dev[1:]:
        if s > end:
            k = bisect.bisect_right(starts, end) - 1
            name = "other"
            while k >= 0:
                if host[k][1] >= end:
                    name = host[k][2]
                    break
                k -= 1
            by[name] += (s - end) * 1e-6
        end = max(end, e)
    return sorted(([k, v] for k, v in by.items()), key=lambda x: -x[1])[:10]


def profiled_slice(advance, launches, labels: set) -> dict:
    """Profile `advance()` (one unit of the window's work, returning the
    scans it completed) until a slice keeps KEPT_ENOUGH of the fused
    kernel's launches (`launches()` reads the program's counter), at most
    SLICE_TRIES times.  Returns the readings of the last slice and the
    completion records of every unit run."""
    from torch.profiler import ProfilerActivity, profile

    records, tries = [], []
    for _ in range(SLICE_TRIES):
        n0 = launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            done = advance()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        records += done
        rows = _device_rows(prof)
        launched = launches() - n0
        seen = sum(e.count for e in rows if KERNEL in e.key)
        kept = seen / launched if launched else 1.0
        tries.append(kept)
        if kept >= KEPT_ENOUGH or not done:
            break
    busy = 1e-6 * sum(e.self_device_time_total for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:10]
    return {"busy_s": busy, "wall_s": wall, "scans": len(done),
            "device_ops": sum(e.count for e in rows),
            "kernel_s": 1e-6 * sum(e.self_device_time_total for e in rows
                                   if KERNEL in e.key),
            "kernel_launches": launched, "kept": tries,
            "breakdown": {
                "device_ops": [[e.key, 1e-6 * e.self_device_time_total] for e in top],
                "idle_gaps": _idle_gaps(prof, labels)},
            }, records
