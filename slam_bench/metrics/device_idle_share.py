"""Share of the profiled slice's wall time in which no operation ran on
the device: 1 - busy / wall, busy from torch.profiler's device records."""

UNIT = "%"


def read(rec):
    s = rec["slice"]
    if s is None or s["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"])
