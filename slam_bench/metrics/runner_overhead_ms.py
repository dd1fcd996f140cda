"""Host ms a scan that `Runner.process_scan` spends outside its StageTimer
stages (padding, GPS intake, input assembly, result queue): each window
scan's wall time minus the stages' time over the window."""
from slam_bench import stats

UNIT = "ms"


def read(rec):
    if not rec["counters1"] or "mapping_step" not in rec["counters1"]:
        return None
    wall = sum(stats.latencies(rec["records"]))
    stages = sum(stats.stage_delta(rec, k) for k in rec["counters1"])
    return 1e3 * (wall - stages) / len(rec["records"])
