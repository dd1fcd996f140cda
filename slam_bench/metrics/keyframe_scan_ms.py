"""Mean latency of the window's scans that saved a keyframe (the save and
the window solve ride on them)."""

UNIT = "ms"


def read(rec):
    out = rec["outputs"]
    lat = [done - handed for i, handed, done in rec["records"] if bool(out.is_kf[i])]
    if not lat:
        return None
    return 1e3 * sum(lat) / len(lat)
