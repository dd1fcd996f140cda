"""The PyTorch port imports without jax or triton, carries an exact copy of
the configuration tree, and generates the same synthetic missions."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_port_helpers as H  # noqa: F401  (single-threaded torch)
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.io import synthetic as jax_synthetic
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch.io import synthetic as port_synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import lio_slam_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'triton', 'lio_slam_tpu')]
print(len(names))
print(','.join(sorted(bad)))
"""


def test_port_imports_without_jax_or_triton():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = (out.stdout.split("\n") + [""])[:2]
    assert int(count) >= 30
    assert bad == "", f"the port imported {bad}"


def _imports_no_jax(modules):
    """Import the port's `modules` and chip_smoke.py (not run) in a fresh
    interpreter; returns the subprocess result, failing if jax, triton or
    the JAX package came in."""
    code = ("import sys, "
            + "".join(f"lio_slam_tpu_torch.{m}, " for m in modules)
            + "chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'triton', 'lio_slam_tpu')]; "
            "assert not bad, bad")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=120)


def test_loop_path_modules_and_chip_smoke_import_no_jax():
    """The modules of the loop-closure / GPS / full-correction path by name,
    and chip_smoke.py (imported, not run)."""
    out = _imports_no_jax(("pipeline.runner", "pipeline.loop_closure",
                           "graph.sparse", "pipeline.gps_fusion", "utils.enu"))
    assert out.returncode == 0, out.stderr
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "import jax" not in src and "lio_slam_tpu." not in src.replace(
        "lio_slam_tpu_torch", "")


def test_archive_checkpoint_and_product_modules_import_no_jax():
    """The archive, checkpoint, map-product and relocalization modules by
    name."""
    out = _imports_no_jax(("pipeline.archive", "pipeline.checkpoint",
                           "pipeline.outputs", "pipeline.relocalization",
                           "ops.heightmap", "io.pcd", "utils.profiling"))
    assert out.returncode == 0, out.stderr


def test_bag_io_modules_import_no_jax():
    """The bag entry point's modules by name; the host runtime they load is
    built from the port's own C++ copy."""
    out = _imports_no_jax(("io.formats", "io.rosbag", "io.native",
                           "io.bag_replay", "io.synthetic_bag", "pipeline.live"))
    assert out.returncode == 0, out.stderr
    for rel in ("io/native.py", "ops/_build.py"):
        src = open(os.path.join(ROOT, "lio_slam_tpu_torch", rel)).read()
        assert "native/" not in src.replace("io/native", ""), rel


def test_corner_path_modules_import_no_jax():
    """The modules of the LOAM corner path, the rebuild-mode map and the
    sweep sensor by name."""
    out = _imports_no_jax(("ops.knn", "ops.features", "ops.registration",
                           "pipeline.keyframes", "pipeline.lio",
                           "io.synthetic", "pipeline.synthetic_mission"))
    assert out.returncode == 0, out.stderr


def test_replay_and_preintegration_modules_import_no_jax():
    """The batch replay, the front-end on the parallel preintegration and
    the deskew table by name."""
    out = _imports_no_jax(("pipeline.replay", "pipeline.imu_frontend",
                           "ops.preintegration", "ops.deskew",
                           "graph.factors", "utils.pointcloud"))
    assert out.returncode == 0, out.stderr


def test_parallel_modules_import_no_jax():
    """The sharded mission's modules by name, each at its JAX counterpart's
    path; the spawned ranks' worker module imports no jax either."""
    mods = ("mesh", "registration", "sparse", "graph", "mission")
    out = _imports_no_jax(tuple(f"parallel.{m}" for m in mods))
    assert out.returncode == 0, out.stderr
    for m in mods:
        for pkg in ("lio_slam_tpu", "lio_slam_tpu_torch"):
            assert os.path.exists(os.path.join(ROOT, pkg, "parallel",
                                               f"{m}.py")), (pkg, m)
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import torch_dist_workers; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'triton', 'lio_slam_tpu')]; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sharded_mission_fixture_matches_its_configuration():
    """The JAX Runner's sharded missions on a mesh of 1 and of 2 devices
    (chip_smoke.py phase 18): bench.py's widths with the sparse full
    solver and the 32768-bucket grid split over the devices; 40 scans, then
    the injected loop's scans until the correction."""
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    f = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                             "sharded_mission_jax.npz"))
    base = sm.bench_config()
    for D in (1, 2):
        cfg = sm.sharded_mission_config(D)
        assert cfg.static.full_solver == "sparse"
        assert cfg.registration.grid_table_size == 32768 // D
        assert dataclasses.replace(
            cfg, static=base.static,
            registration=dataclasses.replace(
                cfg.registration,
                grid_table_size=base.registration.grid_table_size)) == base
        n = f[f"d{D}_poses"].shape[0]
        corrected = int(f[f"d{D}_correction_scan"])
        assert sm.SHARDED_SCANS <= corrected == n - 1 < \
            sm.SHARDED_SCANS + sm.SHARDED_TAIL
        assert f[f"d{D}_poses"].shape == (n, 6)
        assert f[f"d{D}_is_keyframe"].shape == (n,)
        assert f[f"d{D}_registration_iters"].shape == (n,)
        assert f[f"d{D}_rows"].shape == (D,)
        assert int(f[f"d{D}_keyframes"]) == int(f[f"d{D}_keyframes_before"]) + 1


def test_hard_replay_fixture_matches_its_configuration():
    """The recorded JAX replay of the hard tier: the "default" preset at
    tools/rig_ate_table.py's widths, 60 scans of the hard world (2 %
    garbage, 20000 clutter points, 2 m/s), the loop cadence chip_smoke.py
    drives, with each scan's GN trace; and the deskew mission's two
    ATEs."""
    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    f = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                             "hard_replay_jax.npz"))
    cfg = sm.hard_replay_config()
    d = port_config.get_config("default")
    assert dataclasses.replace(cfg, static=d.static) == d
    s = cfg.static
    assert (s.max_raw_points, s.max_scan_points, s.max_map_points,
            s.max_keyframes, s.window_size, s.max_imu_window) == \
        (32768, 8192, 65536, 256, 32, 64)
    assert sm.HARD_KNOBS == dict(outlier_frac=0.02, n_scatter=20000,
                                 speed=2.0)
    assert (sm.HARD_SCANS, sm.HARD_LOOP_EVERY) == (60, 10)
    sensor = synthetic.rig_sensor_for(cfg)
    assert (sensor.n_scan, sensor.samples_per_scan) == (16, 50)
    assert f["poses"].shape == (sm.HARD_SCANS, 6)
    assert f["registration_iters"].shape == f["degenerate"].shape == \
        (sm.HARD_SCANS,)
    assert len(str(f["batch_sha256"])) == 64
    assert f["loop_accepted"].shape == (sm.HARD_SCANS // sm.HARD_LOOP_EVERY, 2)
    # each scan's GN trace: a pose for each iteration and the final one,
    # an inlier count for each iteration
    cap = cfg.registration.max_iterations
    assert f["gn_poses"].shape == (sm.HARD_SCANS, cap + 1, 6)
    assert f["gn_inliers"].shape == (sm.HARD_SCANS, cap)
    traced = np.isfinite(f["gn_poses"]).all(axis=2)
    np.testing.assert_array_equal(traced.sum(axis=1),
                                  f["registration_iters"] + 1)
    np.testing.assert_array_equal((f["gn_inliers"] >= 0).sum(axis=1),
                                  f["registration_iters"])
    assert float(f["ate_rmse_m"]) < 0.2
    assert float(f["deskew_ate_with_m"]) < 0.2
    assert float(f["deskew_ate_without_m"]) >= 4.5 * float(f["deskew_ate_with_m"])


@pytest.mark.parametrize("name,mode,scans", [
    ("corner_mission_jax.npz", "incremental", "CORNER_SCANS"),
    ("rebuild_mission_jax.npz", "rebuild", "REBUILD_SCANS")])
def test_corner_mission_fixtures_match_their_configuration(name, mode, scans):
    """The recorded JAX runs of the corner missions: the mission's length,
    keyframes that store corners, and the configuration chip_smoke.py
    drives (bench_config's widths, corners on at the default capacities,
    the sweep sensor of its lidar)."""
    from lio_slam_tpu_torch.io import synthetic
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    f = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures", name))
    cfg = sm.corner_mission_config(mode)
    base = sm.bench_config()
    assert cfg.static == base.static and cfg.lidar == base.lidar
    assert dataclasses.replace(cfg.registration, use_corner_features=False,
                               local_map_mode="incremental") == base.registration
    d = port_config.StaticConfig()
    assert (cfg.static.max_corner_points, cfg.static.max_corner_map_points) == \
        (d.max_corner_points, d.max_corner_map_points) == (2048, 16384)
    sensor = synthetic.rig_sensor_for(cfg)
    assert (sensor.n_scan, cfg.lidar.horizon_scan, sensor.samples_per_scan) == \
        (16, 1800, 10)
    assert f["poses"].shape == (getattr(sm, scans), 6)
    assert len(str(f["scans_sha256"])) == 64
    k = int(f["keyframes"])
    assert k >= 3 and f["corners"].shape == (k,) and (f["corners"] > 50).all()
    assert int(f["is_keyframe"].sum()) == k
    assert float(f["ate_rmse_m"]) < 0.2


def test_bag_mission_fixture_matches_its_configuration():
    """The recorded JAX replays of the two bags: the bag mission's length,
    its loop and GPS factors, full corrections and recorded topics; the
    hostile bag's length and GPS factors; and the parameter sets of
    `synthetic_mission` that chip_smoke.py writes the bags with."""
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    f = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                             "bag_mission_jax.npz"))
    kw, hk = sm.bag_mission_bag_kwargs(), sm.hostile_bag_kwargs()
    assert (kw["n_scans"], kw["n_points"], kw["seed"], kw["epoch"]) == \
        (sm.BAG_SCANS, 32768, 0, 1.7e9)
    assert (kw["scan_period"], kw["sweep_time"], kw["imu_rate"], kw["speed"],
            kw["yaw_rate"], kw["world_extent"]) == (0.1, 0.1, 100.0, 2.0, 0.6, 60.0)
    assert kw["gps"] and kw["gps_cov"] == 0.25 and kw["raw_gps_topic"] == "/gpsdata"
    assert (hk["n_scans"], hk["n_points"], hk["seed"], hk["yaw_rate"]) == \
        (sm.HOSTILE_SCANS, 32768, 5, 0.0)
    assert (hk["compression"], hk["sensor_layout"], hk["shuffle_window"],
            hk["dup_every"], hk["drop_imu_spans"], hk["gps_rate_hz"]) == \
        ("bz2", "robosense", 0.005, 7, ((1.5, 1.8),), 100.0)
    assert sm.BAG_TOPICS == {"gps": "/gps/fix", "raw_gps": "/gpsdata"}
    assert sm.HOSTILE_TOPICS == {"gps": "/gps/fix", "sensor": "robosense"}
    g = sm.hostile_bag_config().gps
    assert (g.use_gps, g.gps_cov_threshold, g.pose_cov_threshold,
            g.min_travel_before_gps, g.gps_distance_frequency) == \
        (True, 2.0, 0.0, 3.0, 2.0)
    assert sm.hostile_bag_config().static == sm.bench_config().static

    assert f["poses"].shape == (sm.BAG_SCANS, 6)
    assert f["hostile_poses"].shape == (sm.HOSTILE_SCANS, 6)
    assert len(str(f["bag_sha256"])) == len(str(f["hostile_bag_sha256"])) == 64
    assert int(f["loop_count"][-1]) >= 1 and int(f["gps_count"][-1]) >= 1
    assert int(f["hostile_gps_count"][-1]) >= 1
    assert len(f["full_correction_scans"]) >= 2
    assert f["cycle_scan"].tolist() == list(range(sm.LOOP_EVERY - 1, sm.BAG_SCANS,
                                                  sm.LOOP_EVERY))
    counts = dict(zip(f["recorded_topics"].tolist(), f["recorded_counts"].tolist()))
    assert counts["/liorf/mapping/odometry"] == sm.BAG_SCANS
    assert counts["/liorf/gpsdata"] == counts["/sensor_fusion_output"] >= 1
    assert float(f["ate_rmse_m"]) < 1.0 and float(f["hostile_ate_rmse_m"]) < 1.0


def test_loop_mission_fixture_matches_its_configuration():
    """The recorded JAX run of the loop mission has the mission's length and
    holds what chip_smoke.py compares: at least one loop and one GPS factor
    and a full correction."""
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    f = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                             "loop_mission_jax.npz"))
    assert f["poses"].shape == (sm.LOOP_SCANS, 6)
    assert int(f["loop_count"][-1]) >= 1 and int(f["gps_count"][-1]) >= 1
    assert len(f["full_correction_scans"]) >= 2
    assert f["cycle_scan"].tolist() == list(range(sm.LOOP_EVERY - 1, sm.LOOP_SCANS,
                                                  sm.LOOP_EVERY))
    assert f["loop_accepted"].shape == (len(f["cycle_scan"]), 2)
    assert f["keyframe_poses"].shape == (int(f["keyframes"]), 6)
    cfg = sm.loop_mission_config()
    assert cfg.loop.enabled and not cfg.loop.archive_enabled and cfg.gps.use_gps
    assert dataclasses.asdict(cfg.static) == dataclasses.asdict(
        sm.bench_config().static)
    assert dataclasses.asdict(cfg.registration) == dataclasses.asdict(
        sm.bench_config().registration)
    d = port_config.LoopClosureConfig()
    assert (cfg.loop.search_num, cfg.loop.search_radius, cfg.loop.fitness_score,
            cfg.loop.sc_exclude_recent) == (d.search_num, d.search_radius,
                                            d.fitness_score, d.sc_exclude_recent)


def test_archive_mission_fixture_matches_its_configuration():
    """The recorded JAX run of the archive mission: the loop mission at a
    16-keyframe store with the archive on, evictions and at least one
    archive loop, the products and the relocalizations chip_smoke.py
    compares."""
    from lio_slam_tpu_torch.pipeline import synthetic_mission as sm

    f = np.load(os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                             "archive_mission_jax.npz"))
    cfg = sm.archive_mission_config()
    loop = sm.loop_mission_config()
    assert cfg.static.max_keyframes == sm.ARCHIVE_MAX_KEYFRAMES == 16
    assert cfg.loop.archive_enabled and cfg.gps.use_gps
    assert dataclasses.replace(cfg.static, max_keyframes=256) == loop.static
    assert dataclasses.replace(cfg.loop, archive_enabled=False) == loop.loop
    assert (cfg.registration, cfg.gps, cfg.keyframe) == (
        loop.registration, loop.gps, loop.keyframe)
    assert f["poses"].shape == (sm.ARCHIVE_SCANS, 6)
    assert int(f["evictions"]) > 0 and int(f["archive_loops"]) >= 1
    assert int(f["archived_keyframes"]) == int(f["keyframes"]) + int(f["evictions"])
    assert f["archive_events"].shape == (int(f["archive_loops"]), 2)
    assert (f["archive_events"][:, 0] > f["archive_events"][:, 1]).all()
    assert f["reloc_scans"].tolist() == list(sm.RELOC_SCANS)
    assert f["reloc_success"].all() and (f["reloc_matched_kf"] >= 0).all()
    assert min(int(f[k]) for k in ("sor_kept", "height_cells", "saved_points")) > 1000


def test_port_mirrors_module_paths():
    """Every ported module sits at its JAX counterpart's relative path."""
    for rel in ("config.py", "io/formats.py", "io/synthetic.py", "io/pcd.py",
                "ops/heightmap.py", "pipeline/outputs.py",
                "pipeline/checkpoint.py", "pipeline/archive.py",
                "pipeline/relocalization.py", "utils/profiling.py",
                "utils/se3.py", "utils/smallmat.py", "utils/pointcloud.py",
                "ops/deskew.py", "ops/voxel_grid.py", "ops/registration.py",
                "ops/fused_corr.py", "ops/scancontext.py",
                "ops/preintegration.py", "graph/factors.py", "graph/solver.py",
                "graph/sparse.py", "utils/enu.py", "pipeline/gps_fusion.py",
                "pipeline/loop_closure.py", "pipeline/keyframes.py",
                "pipeline/lio.py", "pipeline/imu_frontend.py",
                "pipeline/runner.py", "io/rosbag.py", "io/native.py",
                "io/bag_replay.py", "io/synthetic_bag.py", "pipeline/live.py",
                "ops/knn.py", "ops/features.py"):
        assert os.path.exists(os.path.join(ROOT, "lio_slam_tpu", rel)), rel
        assert os.path.exists(os.path.join(ROOT, "lio_slam_tpu_torch", rel)), rel
    assert os.path.exists(os.path.join(ROOT, "lio_slam_tpu_torch", "ops",
                                       "csrc", "fused_corr.cu"))
    assert os.path.exists(os.path.join(ROOT, "lio_slam_tpu_torch", "io",
                                       "csrc", "liorf_runtime.cpp"))


@pytest.mark.parametrize("preset", sorted(jax_config.PRESETS))
def test_config_presets_equal(preset):
    assert dataclasses.asdict(port_config.get_config(preset)) == \
        dataclasses.asdict(jax_config.get_config(preset))


def test_config_from_dict_equal():
    params = {"N_SCAN": 32, "imuRate": 200.0, "extrinsicRot": [1, 0, 0, 0, 1, 0, 0, 0, 1],
              "loopClosureEnableFlag": False, "unknownKey": 3}
    assert dataclasses.asdict(port_config.config_from_dict(params)) == \
        dataclasses.asdict(jax_config.config_from_dict(params))


def test_make_sequence_matches():
    kw = dict(n_scans=3, n_points=256, seed=2)
    a = jax_synthetic.make_sequence(**kw)
    b = port_synthetic.make_sequence(**kw)
    np.testing.assert_array_equal(a.world, b.world)
    np.testing.assert_array_equal(a.poses, b.poses)
    np.testing.assert_array_equal(a.stamps, b.stamps)
    np.testing.assert_array_equal(a.scan_masks, b.scan_masks)
    np.testing.assert_allclose(a.scans, b.scans, atol=1e-5)
    np.testing.assert_allclose(a.imu_rpy, b.imu_rpy, atol=1e-6)
    assert port_synthetic.ate_rmse(b.poses, b.poses) == 0.0
