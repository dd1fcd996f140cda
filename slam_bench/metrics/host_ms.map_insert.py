"""Host ms a keyframe scan of the save's voxel-map insert
(`save.map_insert`: the keyframe's points into the world frame and the
grid), over the keyframe scans of `spans.runner_scans`: the warm-up's
last cadence and the window, outside the profiler."""
from slam_bench import spans

UNIT = "ms"


def read(rec):
    return spans.mean_ms(spans.runner_scans(rec, "save.map_insert"))
