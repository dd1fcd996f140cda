"""Host ms a scan of the Runner's `imu_frontend` stage (StageTimer: enqueue plus
any device wait inside it), over the window's scans."""
from slam_bench import stats

UNIT = "ms"


def read(rec):
    if "imu_frontend" not in rec["counters1"]:
        return None
    return 1e3 * stats.stage_delta(rec, "imu_frontend") / len(rec["records"])
