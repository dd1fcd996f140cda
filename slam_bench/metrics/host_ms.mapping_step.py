"""Host ms a scan of the Runner's `mapping_step` stage (StageTimer: enqueue plus
any device wait inside it), over the window's scans."""
from slam_bench import stats

UNIT = "ms"


def read(rec):
    if "mapping_step" not in rec["counters1"]:
        return None
    return 1e3 * stats.stage_delta(rec, "mapping_step") / len(rec["records"])
