"""The controls: the reference in the program's place in TF32 and in
bfloat16.  On the CPU their rounding and their keyframe gate; on the card
(marker `cuda`) a run of each cell at its own size where the bfloat16
control fails the cell's limits and the program meets them."""

import json
import time

import pytest
import torch

from benchtree import BENCH, ROOT
from slam_bench import control, reference as ref


def test_rounding_keeps_the_stated_mantissa():
    x = torch.tensor([45.3, 1.0 + 2 ** -9, 0.1], dtype=torch.float64)
    bf = ref.precision("bf16").store(x)
    assert torch.equal(bf, x.to(torch.bfloat16).to(torch.float64))
    tf = ref.precision("tf32").product(x)
    assert float(tf[1]) == 1.0 + 2 ** -9            # 10 bits keep 2^-9
    assert abs(float(tf[0]) - 45.3) <= 45.3 * 2 ** -11
    assert torch.equal(ref.precision("float64").product(x), x)


def test_the_controls_gate_rounds_where_the_reference_does_not():
    params = {"angle_threshold": 0.2, "dist_threshold": 1.0}
    last = torch.eye(4, dtype=torch.float64)
    pose = torch.eye(4, dtype=torch.float64)
    last[:3, 3] = torch.tensor([40.0, 0.0, 0.0])
    pose[:3, 3] = torch.tensor([40.9997, 0.0, 0.0])   # 0.9997 m: no keyframe
    assert ref.keyframe_due(params, last, pose) is False
    assert control._gate(params, ref.precision("float64"))(last, pose) is False
    # in bfloat16 40.9997 is kept as 41.0: the control saves a keyframe
    assert control._gate(params, ref.precision("bf16"))(last, pose) is True


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the controls are read at the cells' own size")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["vlp16_default.stream", "os1_64_mulran.resident_drive"])
def test_every_control_fails_and_the_program_passes(card, workload):
    from slam_bench import check, harness

    cell = harness.load_cell(ROOT / "BENCHMARK.json", BENCH, workload, False, "cuda")
    seed = 2 ** 40 + 99
    inputs, rec, _ = harness.run_window(cell, seed, 10.0, False, time.perf_counter())
    out = rec["outputs"]
    assert check.judge_run(cell.params, inputs, out, seed, cell.limits)["correct"]
    ctl = control.control_outputs(cell.params, inputs, out, seed, "bf16")
    assert not check.judge_run(cell.params, inputs, ctl, seed, cell.limits)["correct"]
