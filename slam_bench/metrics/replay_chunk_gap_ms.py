"""Device ms between two chunks: a chunk's last `replay.scan` end mark to
the next chunk's first start mark (the outputs' clones, the next load's
copies, and the device's wait on the caller), mean over the gaps between
consecutive chunks both in the window and outside the profiler."""
from slam_bench import spans

UNIT = "ms"


def read(rec):
    ch = spans.chunks(rec)
    gaps = [b[0].d0 - a[-1].d1 for (ia, a), (ib, b) in zip(ch, ch[1:])
            if ia and ib and a and b]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
