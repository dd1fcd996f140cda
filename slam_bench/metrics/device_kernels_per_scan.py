"""Device kernels and copies in the profiled slice over its scans (the
host's dispatch load)."""

UNIT = "kernels/scan"


def read(rec):
    s = rec["slice"]
    if s is None or not s["scans"]:
        return None
    return s["device_ops"] / s["scans"]
