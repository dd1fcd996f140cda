"""GN passes a scan that the resident program runs past convergence: its
fixed `max_iterations` passes less the iterations the scan used
(`ReplayOut.iters`), over the window's scans."""
from slam_bench import stats

UNIT = "passes/scan"


def read(rec):
    cap = rec["config"]["as_run"]["registration.max_iterations"]
    it = [cap - int(rec["iters"][i]) for i in stats.window_scans(rec)]
    return sum(it) / len(it) if it else None
