"""95th percentile of every window scan's latency, from its hand-in to
`process_scan` until its pose is on the host (host clock)."""
from slam_bench import stats

UNIT = "ms"


def read(rec):
    lat = stats.latencies(rec["records"])
    return 1e3 * stats.percentile(lat, 95) if len(lat) >= 2 else None
