"""Host ms a keyframe scan of the save's sliding-window solve
(`save.window_solve`: `solve_window_compact`, 2 iterations), over the
keyframe scans of `spans.runner_scans`: the warm-up's last cadence and
the window, outside the profiler."""
from slam_bench import spans

UNIT = "ms"


def read(rec):
    return spans.mean_ms(spans.runner_scans(rec, "save.window_solve"))
