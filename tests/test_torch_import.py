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
    assert int(count) >= 20
    assert bad == "", f"the port imported {bad}"


def test_port_mirrors_module_paths():
    """Every ported module sits at its JAX counterpart's relative path."""
    for rel in ("config.py", "io/formats.py", "io/synthetic.py",
                "utils/se3.py", "utils/smallmat.py", "utils/pointcloud.py",
                "ops/deskew.py", "ops/voxel_grid.py", "ops/registration.py",
                "ops/fused_corr.py", "ops/scancontext.py",
                "ops/preintegration.py", "graph/factors.py", "graph/solver.py",
                "pipeline/keyframes.py", "pipeline/lio.py",
                "pipeline/imu_frontend.py", "pipeline/runner.py"):
        assert os.path.exists(os.path.join(ROOT, "lio_slam_tpu", rel)), rel
        assert os.path.exists(os.path.join(ROOT, "lio_slam_tpu_torch", rel)), rel
    assert os.path.exists(os.path.join(ROOT, "lio_slam_tpu_torch", "ops",
                                       "csrc", "fused_corr.cu"))


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
