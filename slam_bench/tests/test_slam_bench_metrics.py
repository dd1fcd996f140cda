"""The metric arithmetic: a percentile over every scan, the rate to the
last completion, the idle share, and the frozen roofline count against a
count by hand on a tiny grid."""

import importlib.util
import math

import pytest
import torch

from benchtree import BENCH
from slam_bench import roofline, stats


def _metric(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rate_runs_to_the_last_completion():
    recs = [(i, 10.0 + i, 10.5 + i) for i in range(4)]      # last done at 13.5
    assert stats.rate(recs, 10.0) == pytest.approx(4 / 3.5)
    rec = {"records": recs, "t_start": 10.0}
    assert _metric("scans_per_s").read(rec) == pytest.approx(4 / 3.5)


def test_percentile_is_over_every_scan():
    # 180 scans of 100 ms and 20 of 1 s: the 95th percentile is a slow one
    # (a sample of the fast ones, or the median, would read 100 ms)
    lat = [0.1] * 180 + [1.0] * 20
    recs = [(i, 0.0, v) for i, v in enumerate(lat)]
    p95 = _metric("scan_ms_p95").read({"records": recs})
    assert p95 == pytest.approx(1000.0)
    assert _metric("scan_ms_p95").read({"records": recs[:180]}) == pytest.approx(100.0)
    assert stats.percentile(list(range(1, 102)), 50) == pytest.approx(51.0)


def test_idle_share_and_kernels_a_scan():
    sl = {"busy_s": 0.25, "wall_s": 1.0, "device_ops": 500, "scans": 10}
    assert _metric("device_idle_share").read({"slice": sl}) == pytest.approx(75.0)
    assert _metric("device_kernels_per_scan").read({"slice": sl}) == 50.0
    assert _metric("device_idle_share").read({"slice": None}) is None


def test_roofline_count_against_a_hand_count():
    # 4 buckets of 8 slots; 3 points with 2 ids each (O = 2)
    T, C = 4, 8
    counts = torch.tensor([3, 8, 0, 5], dtype=torch.int32)
    hh = torch.tensor([[0, 1, 3],
                       [1, 1, -1]], dtype=torch.int32)   # point 1 repeats id 1
    mask = torch.tensor([True, True, False])
    # live ids of the unmasked points: {0, 1} -> filled 3 + 8 = 11 slots
    n_bytes = 11 * 12 + 2 * 4 + (hh.numel() * 4 + 3 * 12 + 3 + 24 + 180)
    # scanned: point 0 reads 3 + 8, point 1 reads 8 once; 8 flop each, 300 a fit
    flop = (3 + 8 + 8) * 8 + 2 * 300
    want = max(n_bytes / roofline.HBM_BYTES_PER_S, flop / roofline.FP32_FLOP_PER_S)
    assert roofline.kernel_bound_s(T, C, hh, mask, counts) == pytest.approx(want)
    # whole rows where the counts are not given
    whole = max((16 * 12 + 8 + hh.numel() * 4 + 3 * 12 + 3 + 24 + 180)
                / roofline.HBM_BYTES_PER_S,
                (24 * 8 + 600) / roofline.FP32_FLOP_PER_S)
    assert roofline.kernel_bound_s(T, C, hh, mask, None) == pytest.approx(whole)


def test_roofline_share_is_a_mean_a_launch():
    r = {"recorded": 10, "bound_s": 1e-5, "kernel_s": 9e-5, "kernel_launches": 10,
         "kept": [0.9]}
    # 9 of 10 launches kept: 1e-6 bound a launch over 1e-5 s a kept launch
    assert _metric("fused_corr_roofline").read({"roofline": r}) == pytest.approx(10.0)
    assert not math.isnan(_metric("fused_corr_roofline").read({"roofline": r}))
