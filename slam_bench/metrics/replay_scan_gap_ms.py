"""Device ms between two scans of one chunk: a `replay.scan`'s end mark to
the next one's start mark, mean over those gaps (one before each scan of
a chunk but its first) in the window's chunks outside the profiler."""
from slam_bench import spans

UNIT = "ms"


def read(rec):
    gaps = [b.d0 - a.d1 for inside, scans in spans.chunks(rec) if inside
            for a, b in zip(scans, scans[1:])]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
