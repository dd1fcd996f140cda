"""The port's slice as a whole: `Runner(device="cpu")` against the JAX
`Runner` on the small mission of tests/test_runner.py (loop closure off),
and one mapping step from a state carried over from the JAX package.

Tolerance: keyframe decisions and GN iteration counts identical, per-scan
poses within 1e-4 (m and rad); measured 3.3e-6 at seed 0 and 1.1e-6 at
seed 1.  What is left is the JAX front-end's float32 covariance update: the
first update after initialization meets the 1e8 velocity prior and cancels
about 8 digits, which the port avoids by running that 15x15 algebra in
float64 (pipeline/imu_frontend.py).  On seed 2 that gap reaches 1.9e-4 m
and one GN iteration; with the JAX front-end state carried into the port
before every scan it closes to 6.4e-7 m, so the mapping path itself agrees
to float32 rounding.
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, small_config, t
from lio_slam_tpu import config as jax_config
from lio_slam_tpu.pipeline import lio as jlio
from lio_slam_tpu.pipeline.runner import Runner as JaxRunner
from lio_slam_tpu.utils import pointcloud as jpc
from lio_slam_tpu_torch import config as port_config
from lio_slam_tpu_torch import convert
from lio_slam_tpu_torch.io import synthetic
from lio_slam_tpu_torch.ops import fused_corr
from lio_slam_tpu_torch.pipeline import lio as tlio
from lio_slam_tpu_torch.pipeline import synthetic_mission as sm
from lio_slam_tpu_torch.pipeline.runner import Runner
from lio_slam_tpu_torch.utils import pointcloud as tpc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SCANS = 10


def jax_runner_counting_iters():
    """The JAX Runner, with the GN iteration count of each scan recorded
    (its ScanResult does not carry it)."""
    jr = JaxRunner(small_config(jax_config), loop_every=1000)
    iters, step = [], jr.step

    def counting_step(state, inp):
        state, out = step(state, inp)
        iters.append(int(out.registration_iters))
        return state, out

    jr.step = counting_step
    return jr, iters


def run_both(seed, carry_imu_state=False):
    """Both runners over one mission; with `carry_imu_state` the port starts
    every scan from the JAX front-end's state."""
    seq = synthetic.make_sequence(n_scans=N_SCANS, n_points=2048, seed=seed)
    scans, imus = sm.synthetic_inputs(seq, small_config(port_config))
    jr, iters = jax_runner_counting_iters()
    tr = Runner(small_config(port_config), device="cpu")
    ja, tb = [], []
    before = fused_corr.KERNEL_LAUNCHES
    for i in range(N_SCANS):
        if carry_imu_state:
            tr.imu_state = convert.from_numpy(jax.tree.map(np.array, jr.imu_state))
        ja.append(jr.process_scan(scans[i], imu=imus[i]))
        tb.append(tr.process_scan(scans[i], imu=imus[i]))
    assert fused_corr.KERNEL_LAUNCHES == before          # CPU: plain version
    return seq, (jr, ja, iters), (tr, tb)


@pytest.fixture(scope="module", params=[0, 1], ids=lambda s: f"seed{s}")
def missions(request):
    return run_both(request.param)


def test_keyframe_decisions_identical(missions):
    _, (jr, ja, _), (tr, tb) = missions
    assert [r.is_keyframe for r in tb] == [r.is_keyframe for r in ja]
    assert sum(r.is_keyframe for r in tb) >= 2
    assert int(tr.state.store.count) == int(jr.state.store.count)


def test_poses_within_tolerance(missions):
    _, (jr, ja, _), (tr, tb) = missions
    dev = np.abs(np.stack([r.pose for r in tb]) - np.stack([r.pose for r in ja]))
    assert dev.max() < 1e-4, dev.max(axis=0)
    np.testing.assert_allclose(np.stack(tr.trajectory), np.stack(jr.trajectory),
                               atol=1e-4)


def test_registration_iters_identical(missions):
    _, (_, _, iters), (_, tb) = missions
    assert [r.registration_iters for r in tb] == iters
    assert sum(iters) > 0


def test_carried_imu_state_closes_the_gap():
    _, (jr, ja, iters), (tr, tb) = run_both(2, carry_imu_state=True)
    assert [r.is_keyframe for r in tb] == [r.is_keyframe for r in ja]
    assert [r.registration_iters for r in tb] == iters
    dev = np.abs(np.stack([r.pose for r in tb]) - np.stack([r.pose for r in ja]))
    assert dev.max() < 1e-5, dev.max(axis=0)


def test_scan_results(missions):
    seq, (jr, ja, _), (tr, tb) = missions
    for a, b in zip(ja, tb):
        assert b.degenerate == a.degenerate
        assert abs(b.num_inliers - a.num_inliers) <= max(5, a.num_inliers // 100)
        assert b.positioning_mode == a.positioning_mode == 0
        assert (b.imu_rate_poses is None) == (a.imu_rate_poses is None)
        if b.imu_rate_poses is not None:
            assert b.imu_rate_poses.shape == np.asarray(a.imu_rate_poses).shape
            assert b.fused_rate_poses.shape == np.asarray(a.fused_rate_poses).shape
    assert tb[0].registration_iters == 0 and tb[1].registration_iters > 0
    assert not tr.mapping_error
    rel = sm.relative_truth(seq)
    assert synthetic.ate_rmse(np.stack(tr.trajectory), rel) < 0.05


def step_input(mod, pc_mod, seq, i, arr):
    return mod.ScanInput(
        cloud=pc_mod.Cloud(xyz=arr(seq.scans[i]), mask=arr(seq.scan_masks[i])),
        stamp=arr(np.float32(seq.stamps[i])), init_guess=arr(np.zeros(6, np.float32)),
        guess_valid=arr(np.bool_(False)), imu_rpy=arr(np.zeros(3, np.float32)),
        imu_available=arr(np.bool_(False)), gps_pos=arr(np.zeros(3, np.float32)),
        gps_info=arr(np.zeros(3, np.float32)), gps_valid=arr(np.bool_(False)))


def test_step_from_carried_state():
    """Three JAX steps, convert.from_numpy, then one keyframe step in both."""
    seq = synthetic.make_sequence(n_scans=4, n_points=2048, seed=2, speed=4.0)
    jcfg, tcfg = small_config(jax_config), small_config(port_config)
    jstep, tstep = jlio.make_lio_step(jcfg), tlio.make_lio_step(tcfg)
    state = jlio.init_state(jcfg)
    jin = lambda i: step_input(jlio, jpc, seq, i, jnp.asarray)
    for i in range(3):
        state, _ = jstep(state, jin(i))
    carried = jax.tree.map(np.array, state)
    ja, oa = jstep(jax.tree.map(jnp.asarray, carried), jin(3))
    tb, ob = tstep(convert.from_numpy(carried), step_input(tlio, tpc, seq, 3, t))
    assert ob.is_keyframe and bool(oa.is_keyframe)
    assert ob.registration_iters == int(oa.registration_iters) > 0
    np.testing.assert_allclose(n(ob.pose), n(oa.pose), atol=1e-4)
    np.testing.assert_array_equal(n(tb.map_grid.counts), n(ja.map_grid.counts))
    np.testing.assert_allclose(n(tb.map_grid.table), n(ja.map_grid.table), atol=1e-3)
    np.testing.assert_allclose(n(tb.store.poses), n(ja.store.poses), atol=1e-4)
    assert int(tb.store.count) == int(ja.store.count) == 2


def test_unported_features_refused():
    cfg = small_config(port_config)
    with pytest.raises(NotImplementedError):
        Runner(dataclasses.replace(cfg, loop=port_config.LoopClosureConfig()))
    with pytest.raises(NotImplementedError):
        Runner(cfg, fetch_every=4)
    with pytest.raises(NotImplementedError):
        Runner(cfg, auto_checkpoint="ckpt.npz")
    with pytest.raises(NotImplementedError):
        Runner(dataclasses.replace(cfg, gps=port_config.GpsConfig(use_gps=True)))
    seq = synthetic.make_sequence(n_scans=1, n_points=256, seed=0)
    scans, _ = sm.synthetic_inputs(seq, cfg)
    with pytest.raises(NotImplementedError):
        Runner(cfg, device="cpu").process_scan(scans[0],
                                               gps_fix=(45.0, 7.0, 200.0))


def run_cli(*args):
    return subprocess.run([sys.executable, "-m", "lio_slam_tpu_torch.pipeline.runner",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))


def test_cli_help_says_loop_closure_is_off():
    out = run_cli("--help")
    assert out.returncode == 0, out.stderr
    assert "Loop closure is not ported" in out.stdout


def test_runner_defaults_to_the_card_and_never_falls_back():
    """Without a CUDA device the default raises and names the argument to
    pass; it does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default runs on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Runner(small_config(port_config))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Runner(small_config(port_config), device="cuda:0")
    assert Runner(small_config(port_config), device="cpu").device.type == "cpu"


def test_cli_device_defaults_to_cuda():
    assert inspect.signature(Runner.__init__).parameters["device"].default == "cuda"
    out = run_cli("--synthetic", "--scans", "1", "--points", "256")
    if torch.cuda.is_available():
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout.splitlines()[-1])["device"].startswith("cuda")
    else:
        assert out.returncode != 0
        assert 'device="cpu"' in out.stderr
