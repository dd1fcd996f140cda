"""Host ms a keyframe scan of the keyframe save (the `mapping.save` span:
eviction, odometry factor, descriptor, window solve, grid insert), over
the keyframe scans of `spans.runner_scans`: the warm-up's last cadence
and the window, outside the profiler."""
from slam_bench import spans

UNIT = "ms"


def read(rec):
    return spans.mean_ms(spans.runner_scans(rec, "mapping.save"))
