"""Device ms a scan of the resident program: a `replay.scan` span's
start mark (before its input copies) to its end mark (after its output
copies), both graphs between, mean over the window's scans outside the
profiler."""
from slam_bench import spans

UNIT = "ms"


def read(rec):
    marked = [s for s in spans.window(rec, "replay.scan") if s.d0 is not None]
    if not marked:
        return None
    return 1e3 * sum(s.d1 - s.d0 for s in marked) / len(marked)
