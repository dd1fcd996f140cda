"""Host ms a scan of the eager mapping step's registration (the
`mapping.register` span, one a scan), over the scans of
`spans.runner_scans`: the warm-up's last cadence and the window, outside
the profiler."""
from slam_bench import spans

UNIT = "ms"


def read(rec):
    return spans.mean_ms(spans.runner_scans(rec, "mapping.register"))
