"""A copy of the benchmark in a temporary directory at test sizes: the
configurations cut to a few thousand returns and small capacities, so a
run fits on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

def small(returns: int) -> dict:
    """Capacities for `returns` returns a sweep: the scan and keyframe
    clouds half of it (the scan downsample keeps the first voxels in its
    order, so a cap far under the voxels a sweep fills cuts it to a
    strip), a small keyframe store and map."""
    return {"static.max_raw_points": returns, "static.max_scan_points": returns // 2,
            "static.max_map_points": 4 * returns, "static.max_keyframes": 64,
            "static.max_keyframe_points": returns // 2, "static.window_size": 16,
            "static.max_imu_window": 128, "registration.grid_table_size": 8192,
            "static.icp_submap_points": 2 * returns}


def small_tree(tmp: Path, returns: int = 4096) -> Path:
    """BENCHMARK.json and slam_bench/ under `tmp`, every configuration cut
    to `returns` returns a sweep and `small(returns)`'s capacities."""
    shutil.copytree(BENCH, tmp / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cf = json.loads((ROOT / c["file"]).read_text())
        cut = small(returns)
        cf["overrides"] = cut
        cf["as_run"].update(cut)
        cf["sensor"]["returns"] = returns
        cf["imu_window"] = cut["static.max_imu_window"]
        (tmp / c["file"]).write_text(json.dumps(cf))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
