"""Gauss-Newton iterations a scan of the mapping step's registration
(`ScanResult.registration_iters`), over the window's scans."""
from slam_bench import stats

UNIT = "iters/scan"


def read(rec):
    it = [int(rec["iters"][i]) for i in stats.window_scans(rec)]
    return sum(it) / len(it) if it else None
