"""Host ms a keyframe scan of the save's Scan Context descriptor
(`save.sc_descriptor`: `make_descriptor` and `add_descriptor`), over the
keyframe scans of `spans.runner_scans`: the warm-up's last cadence and
the window, outside the profiler."""
from slam_bench import spans

UNIT = "ms"


def read(rec):
    return spans.mean_ms(spans.runner_scans(rec, "save.sc_descriptor"))
