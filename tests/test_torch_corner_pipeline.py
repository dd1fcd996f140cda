"""The LOAM corner path and the rebuild-mode local map through both
packages' `Runner` on the CPU: the slice as a whole, at a small size (the
JAX tests/test_corner_pipeline.py, which is slow in the JAX suite, at 4096
points and 10 scans of the sweep sensor).

- Missions: 10 sweep scans of 4096 points (16 beams, rings and point
  times, IMU windows covering each sweep) through `Runner(device="cpu")`
  and the JAX `Runner`, with corners on the incremental map and on the
  rebuild-mode map: trajectories within 1e-3 m and 1e-3 rad, the same
  keyframe flags, keyframe count and corners stored per keyframe.
- Map assembly: `assemble_local_map` / `assemble_corner_map` on the JAX
  mission's final store select the same keyframes and give the same
  clouds (within 1e-5 m after sorting).
- Scan prep: the corners the Runner extracts from the square room of the
  JAX test are JAX's, point for point.
- State: the JAX final state (corner clouds in its store) converted into
  the port's, one step of each package from it gives the same pose; the
  port's checkpoint in corner mode resumes with the uninterrupted run's
  bits; a surface-only state carries capacity-1 corner tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as H  # noqa: F401  (single-threaded torch)
from torch_port_helpers import n, t
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.pipeline import keyframes as jkf
from lio_slam_tpu.pipeline import lio as jlio
from lio_slam_tpu.pipeline.runner import Runner as JaxRunner
from lio_slam_tpu.utils import pointcloud as jpc
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch import convert
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.pipeline import keyframes as tkf
from lio_slam_tpu_torch.pipeline import lio as tlio
from lio_slam_tpu_torch.pipeline import synthetic_mission as sm
from lio_slam_tpu_torch.pipeline.runner import Runner, extract_corners
from lio_slam_tpu_torch.utils import pointcloud as tpc

N_SCANS = 10
N_POINTS = 4096


def corner_config(m, mode="incremental"):
    """A 4096-point mission config with the corner term on."""
    return m.Config(
        static=m.StaticConfig(max_raw_points=N_POINTS, max_scan_points=2048,
                              max_map_points=16384, max_keyframes=32,
                              max_keyframe_points=2048, max_loop_queue=2,
                              max_gps_queue=2, window_size=8,
                              max_imu_window=32, max_corner_points=512,
                              max_corner_map_points=4096),
        imu=m.ImuConfig(imu_rate=100.0),
        registration=m.RegistrationConfig(use_corner_features=True,
                                          local_map_mode=mode,
                                          grid_table_size=8192),
        keyframe=m.KeyframeConfig(dist_threshold=0.5),
        loop=m.LoopClosureConfig(enabled=False))


@pytest.fixture(scope="module")
def inputs():
    return sm.corner_mission_inputs(corner_config(port_config),
                                    n_scans=N_SCANS, n_points=N_POINTS)


@pytest.fixture(scope="module", params=["incremental", "rebuild"])
def missions(request, inputs):
    seq, scans, imus = inputs
    mode = request.param
    port = Runner(corner_config(port_config, mode), device="cpu")
    ref = JaxRunner(corner_config(jax_config, mode))
    out = {}
    for name, runner in (("port", port), ("jax", ref)):
        out[name] = (runner, [runner.process_scan(scans[i], imu=imus[i])
                              for i in range(N_SCANS)])
    return mode, seq, out


def test_missions_match_jax(missions):
    _, seq, out = missions
    (pr, pres), (jr, jres) = out["port"], out["jax"]
    pp = np.stack([r.pose for r in pres])
    jp = np.stack([r.pose for r in jres])
    assert np.isfinite(pp).all()
    assert np.abs(pp[:, 3:] - jp[:, 3:]).max() < 1e-3
    assert np.abs(pp[:, :3] - jp[:, :3]).max() < 1e-3
    assert [r.is_keyframe for r in pres] == [r.is_keyframe for r in jres]
    k = int(pr.state.store.count)
    assert k == int(jr.state.store.count) and k >= 3
    corners = n(pr.state.store.corner_masks[:k]).sum(1)
    np.testing.assert_array_equal(
        corners, np.asarray(jr.state.store.corner_masks[:k]).sum(1))
    assert (corners > 10).all(), corners
    assert pr.state.store.corner_clouds.shape[1] == 512
    assert synthetic.ate_rmse(pp, sm.relative_truth(seq)) < 0.15


def test_map_assembly_matches_jax(missions):
    """Both local maps on the JAX mission's final store, at its last
    pose: the same keyframes, the same clouds."""
    mode, _, out = missions
    jr, jres = out["jax"]
    cfg = corner_config(port_config, mode)
    r = cfg.registration
    jstore = jr.state.store
    pstore = convert.from_numpy(jax.tree.map(np.asarray, jr.state)).store
    pos = jres[-1].pose[3:].astype(np.float32)
    now = np.float32(N_SCANS * 0.1)
    sel = dict(radius=r.surrounding_radius, recent_sec=2.0, max_selected=4)
    ji, jv = jkf._select_nearby(jstore, jnp.asarray(pos), jnp.asarray(now),
                                **sel)
    pi, pv = tkf._select_nearby(pstore, t(pos), t(now), **sel)
    np.testing.assert_array_equal(n(pi), np.asarray(ji))
    np.testing.assert_array_equal(n(pv), np.asarray(jv))
    for fj, fp, leaf, cap in (
            (jkf.assemble_local_map, tkf.assemble_local_map,
             r.mapping_surf_leaf_size, cfg.static.max_map_points),
            (jkf.assemble_corner_map, tkf.assemble_corner_map,
             r.mapping_corner_leaf_size, cfg.static.max_corner_map_points)):
        cj = fj(jstore, jnp.asarray(pos), jnp.asarray(now), leaf_size=leaf,
                map_capacity=cap, **sel)
        cp = fp(pstore, t(pos), t(now), leaf_size=leaf, map_capacity=cap,
                **sel)
        a = np.asarray(cj.xyz)[np.asarray(cj.mask)]
        b = n(cp.xyz)[n(cp.mask)]
        assert len(a) == len(b) > 50
        key = lambda x: np.lexsort(np.round(x / 0.01).T[::-1])
        np.testing.assert_allclose(b[key(b)], a[key(a)], atol=1e-5)


def room_scan(n_scan=16, horizon=360, half=8.0):
    """The square room of tests/test_corner_pipeline.py, beams at column
    centres: (xyz, ring, time)."""
    rows, cols = np.meshgrid(np.arange(n_scan), np.arange(horizon),
                             indexing="ij")
    az = (cols + 0.5) / horizon * 2 * np.pi - np.pi
    elev = (rows / (n_scan - 1) - 0.2) * np.deg2rad(30.0)
    ca, sa = np.cos(az), np.sin(az)
    r_wall = half / np.maximum(np.abs(ca), np.abs(sa))
    xyz = np.stack([(r_wall * ca).astype(np.float32),
                    (r_wall * sa).astype(np.float32),
                    (r_wall * np.tan(elev)).astype(np.float32) + 1.0],
                   -1).reshape(-1, 3)
    return xyz, rows.reshape(-1).astype(np.int32), \
        (cols.reshape(-1) / horizon * 0.1).astype(np.float32)


def test_runner_prep_extracts_jax_corners():
    lidar = dict(n_scan=16, horizon_scan=360, lidar_min_range=1.0,
                 lidar_max_range=50.0)
    cfgs = []
    for m in (port_config, jax_config):
        cfg = corner_config(m)
        cfgs.append(dataclasses.replace(
            cfg, lidar=m.LidarConfig(**lidar),
            static=dataclasses.replace(cfg.static, max_raw_points=8192)))
    xyz, ring, tm = room_scan()
    N = cfgs[0].static.max_raw_points
    pad = lambda a: np.concatenate([a, np.zeros((N - len(a),) + a.shape[1:],
                                                a.dtype)])
    mask = np.arange(N) < len(xyz)
    W = cfgs[0].static.max_imu_window
    args = (pad(xyz), pad(tm), mask, pad(ring), np.zeros((W, 3), np.float32),
            np.zeros(W, np.float32), np.zeros(W, bool), np.bool_(False),
            np.zeros(3, np.float32))
    _, cp = Runner(cfgs[0], device="cpu")._prep(*map(t, args))
    _, cj = JaxRunner(cfgs[1])._prep(*map(jnp.asarray, args))
    np.testing.assert_array_equal(n(cp.mask), np.asarray(cj.mask))
    m = n(cp.mask)
    np.testing.assert_array_equal(n(cp.xyz)[m], np.asarray(cj.xyz)[m])
    pts = n(cp.xyz)[m]
    assert len(pts) > 8
    corners = np.array([[8, 8], [8, -8], [-8, 8], [-8, -8]], np.float32)
    d = np.linalg.norm(pts[:, None, :2] - corners[None], axis=-1).min(1)
    assert (d < 1.0).mean() > 0.5


def scan_input(module, pc_module, as_array, scan, corner, stamp, guess):
    """A ScanInput of either package from numpy arrays."""
    A = as_array
    return module.ScanInput(
        cloud=pc_module.Cloud(xyz=A(scan[0]), mask=A(scan[1])),
        stamp=A(np.float32(stamp)), init_guess=A(guess),
        guess_valid=A(np.bool_(True)), imu_rpy=A(np.zeros(3, np.float32)),
        imu_available=A(np.bool_(False)), gps_pos=A(np.zeros(3, np.float32)),
        gps_info=A(np.zeros(3, np.float32)), gps_valid=A(np.bool_(False)),
        corner=pc_module.Cloud(xyz=A(corner[0]), mask=A(corner[1])))


def test_step_from_converted_jax_state(missions):
    """The JAX state, corner clouds in its store, carried into the port:
    one more scan through each package's step gives the same pose."""
    mode, seq, out = missions
    jr, jres = out["jax"]
    pcfg, jcfg = corner_config(port_config, mode), corner_config(jax_config, mode)
    jstate = jax.tree.map(np.asarray, jr.state)
    pstate = convert.from_numpy(jstate)
    assert pstate.store.corner_clouds.shape == (32, 512, 3)
    np.testing.assert_array_equal(n(pstate.store.corner_masks),
                                  jstate.store.corner_masks)
    # the next scan as the step sees it: the last scan again, a metre on
    i = N_SCANS - 1
    m = seq.scan_masks[i]
    xyz = seq.scans[i]
    ring = seq.rings[i]
    c = extract_corners(t(xyz), t(m), t(ring), pcfg)
    corner = (n(c.xyz), n(c.mask))
    guess = (jres[-1].pose + np.array([0, 0, 0, 0.2, 0, 0], np.float32))
    stamp = float(seq.stamps[i]) + 0.1
    jout = jlio.make_lio_step(jcfg)(jr.state, scan_input(
        jlio, jpc, jnp.asarray, (xyz, m), corner, stamp, guess))[1]
    pout = tlio.make_lio_step(pcfg)(pstate, scan_input(
        tlio, tpc, t, (xyz, m), corner, stamp, guess))[1]
    assert pout.registration_iters == int(jout.registration_iters) > 0
    np.testing.assert_allclose(n(pout.pose), np.asarray(jout.pose), atol=1e-4)


def test_corner_checkpoint_resumes_bit_equal(tmp_path, inputs):
    """A corner-mode mission checkpointed at scan 4 and resumed: scans 4-7
    give the uninterrupted run's poses, bit for bit."""
    _, scans, imus = inputs
    cfg = corner_config(port_config)
    ref = Runner(cfg, device="cpu")
    ref_out = [ref.process_scan(scans[i], imu=imus[i]) for i in range(8)]
    r1 = Runner(cfg, device="cpu")
    for i in range(4):
        r1.process_scan(scans[i], imu=imus[i])
    path = str(tmp_path / "corner.npz")
    r1.save_checkpoint(path)
    r2 = Runner.resume(path, cfg, device="cpu")
    assert torch.equal(r2.state.store.corner_clouds, r1.state.store.corner_clouds)
    out = [r2.process_scan(scans[i], imu=imus[i]) for i in range(4, 8)]
    for a, b in zip(ref_out[4:], out):
        np.testing.assert_array_equal(b.pose, a.pose)


def test_surf_only_state_has_unit_corner_capacity():
    """Surface-only configs carry capacity-1 corner tensors; a ScanInput
    without `corner` runs, and a custom MapOps is refused on the corner
    and rebuild paths, as in the JAX step."""
    cfg = dataclasses.replace(
        corner_config(port_config),
        registration=port_config.RegistrationConfig(grid_table_size=8192))
    state = tlio.init_state(cfg)
    assert state.store.corner_clouds.shape[1] == 1
    seq = synthetic.make_sequence(n_scans=1, n_points=2048, seed=0)
    inp = tlio.ScanInput(
        cloud=tpc.Cloud(xyz=t(seq.scans[0]), mask=t(seq.scan_masks[0])),
        stamp=t(np.float32(0)), init_guess=torch.zeros(6),
        guess_valid=t(np.bool_(False)), imu_rpy=torch.zeros(3),
        imu_available=t(np.bool_(False)), gps_pos=torch.zeros(3),
        gps_info=torch.zeros(3), gps_valid=t(np.bool_(False)))
    _, out = tlio.make_lio_step(cfg)(state, inp)
    assert torch.isfinite(out.pose).all() and out.is_keyframe
    ops = tlio.default_map_ops(cfg)
    for mode, corners in (("incremental", True), ("rebuild", False)):
        bad = dataclasses.replace(cfg, registration=dataclasses.replace(
            cfg.registration, use_corner_features=corners, local_map_mode=mode))
        with pytest.raises(ValueError, match="MapOps"):
            tlio.make_lio_step(bad, ops=ops)
