"""One run of one cell: inputs from the seed, the program warmed up on
the cell's own traffic, a measured window, the check, one result line.

Everything that belongs to one configuration, traffic mix, entry or
metric is a file of its own, found by name:

- `BENCHMARK.json` lists the configurations (`file`), cells and metrics;
- `traffic/<traffic>.json`: the route, the world, the entry that feeds
  the program, its cadence, warm-up and the most scans a second it is
  given (inputs are made for that many);
- `entries/<entry>.py`: a `Driver(cell, inputs)` with `advance()` (one
  unit of work, returning [(scan, handed in, completed)]),
  `units_left()`, `counters()`, `iterations()`, `outputs(in_window)` and
  `close()`, and its `UNIT`;
- `metrics/<metric>.py`: `read(rec)` -> the number, or None where the
  run holds nothing to read;
- `limits/<cell>.json`: the limit of each number the check compares.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "lio_slam_tpu")   # top-level names
TRACE_SKIP_UNITS = 2       # units of the window run before the slices


class Cell(NamedTuple):
    name: str
    config: dict               # the configuration's file
    traffic: dict              # the traffic mix's file
    program_config: object     # the program's Config, as run
    params: dict               # the reference's parameters (from the file)
    limits: dict
    metrics: list              # [(name, module)] this run reports
    entry: object              # the entry's module
    device: torch.device


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        "slam_bench_" + name.replace(".", "_").replace("/", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def program_config(config: dict):
    """The program's Config for a configuration file: its preset with its
    overrides; every `as_run` key is checked against the result."""
    from lio_slam_tpu_torch.config import get_config

    cfg = get_config(config["preset"])
    for key, value in config.get("overrides", {}).items():
        group, field = key.split(".")
        cfg = dataclasses.replace(cfg, **{group: dataclasses.replace(
            getattr(cfg, group), **{field: value})})
    for key, want in config["as_run"].items():
        group, field = key.split(".")
        got = getattr(getattr(cfg, group), field)
        got = list(got) if isinstance(got, tuple) else got
        if got != want:
            raise ValueError(f"{config['name']}: {key} runs as {got!r}, "
                             f"the file states {want!r}")
    return cfg


def reference_params(config: dict) -> dict:
    """The reference's parameters, read from the configuration's file."""
    a = config["as_run"]
    return {
        "lidar_min_range": a["lidar.lidar_min_range"],
        "lidar_max_range": a["lidar.lidar_max_range"],
        "crop_box_min": a["lidar.crop_box_min"], "crop_box_max": a["lidar.crop_box_max"],
        "point_filter_num": a["lidar.point_filter_num"],
        "downsample_rate": a["lidar.downsample_rate"],
        "surf_leaf": a["registration.mapping_surf_leaf_size"],
        "nn_radius": a["registration.nn_radius"],
        "plane_dist_thresh": a["registration.plane_dist_thresh"],
        "robust_weight_floor": a["registration.robust_weight_floor"],
        "max_iterations": a["registration.max_iterations"],
        "rot_converge": a["registration.rot_converge"],
        "trans_converge": a["registration.trans_converge"],
        "min_surf_points": a["registration.min_surf_points"],
        "surrounding_radius": a["registration.surrounding_radius"],
        "angle_threshold": a["keyframe.angle_threshold"],
        "dist_threshold": a["keyframe.dist_threshold"],
        "loop_search_num": a["loop.search_num"],
    }


def load_cell(spec_path: Path, bench_dir: Path, name: str, trace: bool,
              device) -> Cell:
    spec = json.loads(Path(spec_path).read_text())
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {spec_path}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((Path(spec_path).parent / conf["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "limits" / f"{name}.json").read_text())
    names = []
    for m in spec["end_to_end"] if not trace else spec["per_layer"]:
        if name in m.get("workloads", [name]):
            names.append(m["name"])
    metrics = [(m, _module(bench_dir / "metrics" / f"{m}.py", m)) for m in names]
    entry = _module(bench_dir / "entries" / f"{traffic['entry']}.py", traffic["entry"])
    return Cell(name=name, config=config, traffic=traffic,
                program_config=program_config(config),
                params=reference_params(config), limits=limits["limits"],
                metrics=metrics, entry=entry, device=torch.device(device))


def scans_needed(traffic: dict, seconds: float) -> int:
    """Scans made for a run: the warm-up and as many as the window could
    take at `max_scans_per_s`, in whole cadences (a chunk's scans)."""
    unit = traffic.get("loop_every", 1)
    n = traffic["warmup_scans"] + int(math.ceil(seconds * traffic["max_scans_per_s"]))
    return int(math.ceil(n / unit)) * unit


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_process: float) -> dict:
    """The run: the result line's object, `info` and `checks` (each
    compared number beside its limit) last."""
    from slam_bench import check

    inputs, rec, peak = run_window(cell, seed, seconds, trace, t_process)
    out, records, rec_slice = rec["outputs"], rec["records"], rec["slice"]
    metrics = {}
    for name, mod in cell.metrics:
        v = mod.read(rec)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": mod.UNIT}
    verdict = check.judge_run(cell.params, inputs, out, seed, cell.limits)
    poses = out.poses[out.in_window]
    failed = int((~torch.isfinite(poses).all(1)).sum())
    result = {"correct": verdict["correct"] and failed == 0,
              "attempted": len(records), "failed": failed, "metrics": metrics,
              "device": device_info(cell.device, peak, rec_slice)}
    if rec_slice is not None:
        result["breakdown"] = rec_slice["breakdown"]
    n = len(out.in_window)
    result["info"] = {**verdict["info"], "scans_in_window": len(records),
                      "kept_share": rec_slice["kept"] if rec_slice else None,
                      "corrections_in_window": sum(
                          bool(out.in_window[min(c + 1, n - 1)]) for c in out.corrections)}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in verdict["checks"].items()}
    return result


def run_window(cell: Cell, seed: int, seconds: float, trace: bool,
               t_process: float):
    """Inputs, warm-up and the measured window: (inputs, the record the
    metric readers take, the device's memory peak)."""
    from slam_bench import generator

    dev = cell.device
    phases = [("imports", time.perf_counter())]
    n_scans = scans_needed(cell.traffic, seconds)
    inputs = generator.make_inputs(cell.config, cell.traffic, seed, n_scans, dev)
    _sync(dev)
    phases.append(("inputs", time.perf_counter()))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    driver = cell.entry.Driver(cell, inputs)
    _sync(dev)
    phases.append(("program", time.perf_counter()))
    unit = cell.traffic.get("loop_every", 1) if cell.entry.UNIT == "chunk" else 1
    for _ in range(cell.traffic["warmup_scans"] // unit):
        driver.advance()
    if trace:
        from slam_bench import trace as tr
        tr.warm_profiler(dev)
    _sync(dev)
    phases.append(("warm_up", time.perf_counter()))
    starts = [t_process] + [t for _, t in phases]
    print("setup phases (s): " + ", ".join(
        f"{k} {t - t0:.3f}" for (k, t), t0 in zip(phases, starts)),
        file=sys.stderr, flush=True)
    counters0 = driver.counters()
    if hasattr(driver, "timed"):
        driver.timed = trace
    t_start = time.perf_counter()
    records, rec_slice, rec_roof = [], None, None
    while driver.units_left():
        if trace and rec_slice is None and len(records) >= TRACE_SKIP_UNITS * unit:
            rec_slice, done = _slice(cell, driver)
            records += done
            if any(m == "fused_corr_roofline" for m, _ in cell.metrics):
                rec_roof, done = _roofline_slice(cell, driver)
                records += done
            continue
        records += driver.advance()
        if records[-1][2] - t_start >= seconds:
            break
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules loaded in this process: {bad}")
    counters1 = driver.counters()
    in_window = torch.zeros(driver.next * unit, dtype=torch.bool)
    for i, _, _ in records:
        in_window[i] = True
    out = driver.outputs(in_window)
    iters = driver.iterations()
    driver.close()
    del driver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec = {"cell": cell.name, "config": cell.config, "traffic": cell.traffic,
           "t_start": t_start, "t_process": t_process, "records": records,
           "counters0": counters0, "counters1": counters1,
           "iters": iters, "outputs": out,
           "slice": rec_slice, "roofline": rec_roof}
    return inputs, rec, peak


def device_info(dev, peak: int, rec_slice) -> dict:
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    if rec_slice is not None:
        info.update(busy_s=rec_slice["busy_s"], window_s=rec_slice["wall_s"])
    return info


def _launches():
    from lio_slam_tpu_torch.ops import fused_corr
    return fused_corr.KERNEL_LAUNCHES


LABELS = {"runner.process_scan", "replay.scans", "loop_closure",
          "full_correction", "imu_predict", "deskew", "mapping_step",
          "imu_frontend", "archive_loop", "host_fetch"}


def _slice(cell: Cell, driver):
    from slam_bench import trace as tr
    units = max(1, cell.traffic["trace_scans"] // (cell.traffic.get("loop_every", 1)
                                                  if cell.entry.UNIT == "chunk" else 1))

    def advance():
        done = []
        for _ in range(units):
            if driver.units_left():
                done += driver.advance()
        return done
    return tr.profiled_slice(advance, _launches, LABELS)


def _roofline_slice(cell: Cell, driver):
    """A slice with the fused kernel's wrapper recording each launch's
    operands: (the slice's readings with `bound_s`, the launches' summed
    bound, and the completions)."""
    from lio_slam_tpu_torch.ops import fused_corr
    from slam_bench import roofline
    from slam_bench import trace as tr

    launches = []
    inner = fused_corr.fused_ne_from_bucket_ids

    def recording(table, hh, scan, scan_mask, pose6, *a, counts=None, **kw):
        launches.append((table.shape[0], table.shape[1], hh.clone(),
                         scan_mask.clone(), None if counts is None else counts.clone()))
        return inner(table, hh, scan, scan_mask, pose6, *a, counts=counts, **kw)

    fused_corr.fused_ne_from_bucket_ids = recording
    try:
        def advance():
            launches.clear()          # a slice taken again records anew
            return driver.advance()
        reading, done = tr.profiled_slice(advance, _launches, LABELS)
    finally:
        fused_corr.fused_ne_from_bucket_ids = inner
    reading["bound_s"] = sum(roofline.kernel_bound_s(T, C, hh, m, c)
                             for T, C, hh, m, c in launches)
    reading["recorded"] = len(launches)
    return reading, done
