"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Each test builds its inputs with numpy from a seed and hands the same
arrays to the JAX function (on the CPU) and to its counterpart in
`lio_slam_tpu_torch`.  Torch runs single-threaded: the suite runs under
several pytest-xdist workers at once.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

torch.set_num_threads(1)


def to_jax_config(cfg, jax_config_module):
    """The JAX package's Config with the same values as a port Config."""
    parts = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            cls = getattr(jax_config_module, type(v).__name__)
            v = cls(**{g.name: getattr(v, g.name) for g in dataclasses.fields(v)})
        parts[f.name] = v
    return jax_config_module.Config(**parts)


def small_config(config_module):
    """The small mission config of tests/test_runner.py, loop closure off."""
    m = config_module
    return m.Config(
        static=m.StaticConfig(max_raw_points=2048, max_scan_points=2048,
                              max_map_points=8192, max_keyframes=16,
                              max_keyframe_points=1024, max_loop_queue=2,
                              max_gps_queue=2, window_size=8,
                              max_imu_window=32),
        registration=m.RegistrationConfig(degeneracy_eig_thresh=10.0),
        loop=m.LoopClosureConfig(enabled=False))


def t(x, dtype=None):
    """numpy -> CPU tensor (copy)."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def n(x):
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def planar_scene(seed=0, n_map=4096, n_scan=512):
    """Ground plane + wall + noise (the scene of tests/test_fused_corr.py)."""
    rs = np.random.RandomState(seed)
    g = np.stack([rs.uniform(-20, 20, n_map // 2),
                  rs.uniform(-20, 20, n_map // 2),
                  rs.randn(n_map // 2) * 0.01], 1)
    w = np.stack([np.full(n_map // 2, 8.0) + rs.randn(n_map // 2) * 0.01,
                  rs.uniform(-20, 20, n_map // 2),
                  rs.uniform(0, 5, n_map // 2)], 1)
    map_pts = np.concatenate([g, w]).astype(np.float32)
    sel = rs.permutation(n_map)[:n_scan]
    scan = (map_pts[sel] + rs.randn(n_scan, 3) * 0.02).astype(np.float32)
    return map_pts, scan


def repaired_jax_window_for(self, scan):
    """The JAX `LiveFeed._window_for` with the port's window start: after
    the samples the previous scan's correction took
    (`lio_slam_tpu_torch.pipeline.live.correction_takes`), not 1e-9 s after
    its stamp, which at epoch stamps hands the sample one float64 ulp after
    the stamp to two corrections.  The JAX package stays as it is; its
    replays are compared with the port's under this patch."""
    from lio_slam_tpu_torch.pipeline.live import correction_takes

    sweep_end = float(scan.stamp) + (float(scan.time.max())
                                     if scan.time is not None
                                     and len(scan.time) else 0.0)
    last = self._last_scan_stamp
    ts, vals = self.imu_queue.window(
        last if last is not None else -1e18,
        sweep_end + self.deskew_tail_margin, margin=0.0, max_n=4096)
    if last is not None and len(ts):
        fresh = ~correction_takes(ts, last)
        ts, vals = ts[fresh], vals[fresh]
    if len(ts) == 0:
        return None
    quat = vals[:, 6:10]
    return {"stamps": ts, "acc": vals[:, 0:3].copy(),
            "gyr": vals[:, 3:6].copy(),
            "quat": None if np.isnan(quat).all() else quat.copy()}


@contextlib.contextmanager
def repaired_jax_feed():
    """The JAX `LiveFeed` with `repaired_jax_window_for` inside the block."""
    from lio_slam_tpu.pipeline import live as jlive

    original = jlive.LiveFeed._window_for
    jlive.LiveFeed._window_for = repaired_jax_window_for
    try:
        yield
    finally:
        jlive.LiveFeed._window_for = original


def jax_fused_interpret(scan, scan_mask, grid, cfg):
    """The JAX `registration._maybe_fused` as it is off the CPU, with the
    Pallas kernel in interpret mode: patched in where a JAX run must hold
    its candidate block for `corr_refresh_every` iterations, as the port
    does (on the CPU the JAX registration takes its unfused path, which
    finds fresh correspondences at every iteration)."""
    from lio_slam_tpu.ops import fused_corr as jfc
    from lio_slam_tpu.utils import se3 as jse3

    if grid is None or not cfg.use_fused_kernel:
        return None
    kw = dict(halo=cfg.grid_halo, nn_radius=cfg.nn_radius,
              plane_dist_thresh=cfg.plane_dist_thresh,
              robust_weight_floor=cfg.robust_weight_floor, interpret=True)
    if cfg.corr_refresh_every <= 1:
        return lambda pose: jfc.fused_normal_equations(grid, scan, scan_mask,
                                                       pose, **kw)

    def gather_fn(pose):
        R, t = jse3.pose6_to_Rt(pose)
        return jfc.gather_planar(grid, jse3.transform_points(R, t, scan),
                                 cfg.grid_halo)

    def from_cand_fn(cand, hh, pose):
        return jfc.fused_ne_from_candidates(cand, hh, scan, scan_mask, pose,
                                            **kw)

    return (gather_fn, from_cand_fn, int(cfg.corr_refresh_every))
