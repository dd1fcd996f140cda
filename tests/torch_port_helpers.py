"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

Each test builds its inputs with numpy from a seed and hands the same
arrays to the JAX function (on the CPU) and to its counterpart in
`lio_slam_tpu_torch`.  Torch runs single-threaded: the suite runs under
several pytest-xdist workers at once.
"""

from __future__ import annotations

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
