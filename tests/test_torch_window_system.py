"""The keyframe save's window system (`graph/solver.assemble_window`): the
CUDA kernel `ops/csrc/window_system.cu` run on the CPU (compiled with g++
against `tests/cuda_emulator.h`, `tests/torch_port_cuda_emulator.py`)
against the plain version (`solver.assemble_window_plain`), which
linearizes every slot with `graph/factors.linearize_*` (torch.func.jacfwd)
and scatters the blocks, on the graphs of `torch_port_helpers.WINDOW_CASES`:
a pure chain; loops (both ends in the window, one, none, two factors on
one pair, stale slots, one measured half a turn off); GPS factors in and
out of the window; fewer keyframes than the window (none, one, five); a
window wider than the store; a ring-evicted store whose prior has moved,
at windows with and without the prior.  The card holds the compiled kernel
to the same cases (tests/test_torch_cuda.py).

The two agree to float32 rounding, not bit for bit: the kernel's sums run
in another order and its sin, cos, acos and sqrt are the C library's.  The
tolerances, each with its reason, are `torch_port_helpers.WINDOW_*`; every
one leaves the float64 plain version's answer inside it too, but near pi
(see WINDOW_POSE_ATOL_HALF_TURN)."""

import pytest
import torch

import torch_port_cuda_emulator as E
from torch_port_helpers import (WINDOW_CASES, assert_window_close,
                                window_blocks, window_case, window_pose_atol,
                                window_truth)
from lio_slam_tpu_torch.graph import solver
from lio_slam_tpu_torch.ops import window_system as ws


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return E.build_window_system(tmp_path_factory.mktemp("emulated_ws"))


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_kernel_matches_the_plain_system(lib, case):
    """H and b blockwise against the plain version and the float64 one; the
    kernel writes every word (its outputs start as NaN), H is symmetric bit
    for bit, and a second launch repeats the bits."""
    graph, count, W = window_case(case)
    got = E.window_system_emulated(lib, graph, count, W)
    assert not any(torch.isnan(x).any() for x in got)
    assert_window_close(got, solver.assemble_window_plain(graph, count, W), W,
                        truth=window_truth(case, graph, count, W))
    assert torch.equal(got[0], got[0].T)
    again = E.window_system_emulated(lib, graph, count, W)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_idle_slots_get_the_identity(lib):
    """Window slots past `count` have an identity diagonal block, zero rows
    and columns and a zero b; a store with no keyframe is all identity."""
    for case in ("short", "empty"):
        graph, count, W = window_case(case)
        H, b = E.window_system_emulated(lib, graph, count, W)
        n = int(count)
        idle_blocks = window_blocks(H, W)[n:, n:].reshape(-1, 6, 6)
        assert torch.equal(idle_blocks[::W - n + 1],
                           torch.eye(6).expand(W - n, 6, 6))
        idle = torch.arange(6 * W) >= 6 * n
        assert torch.equal(H[idle][:, ~idle], torch.zeros(6 * (W - n), 6 * n))
        assert torch.equal(b[idle], torch.zeros(6 * (W - n)))


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_window_solve_on_the_kernel_matches(lib, monkeypatch, case):
    """`solve_window_compact`'s poses after its two iterations with the
    kernel's systems against the plain version's; the solve moved them."""
    graph, count, W = window_case(case)
    ref = solver.solve_window_compact(graph, count, W, iterations=2)
    monkeypatch.setattr(solver, "assemble_window",
                        lambda g, c, w: E.window_system_emulated(lib, g, c, w))
    got = solver.solve_window_compact(graph, count, W, iterations=2)
    torch.testing.assert_close(got.poses, ref.poses, rtol=0,
                               atol=window_pose_atol(case, count, W))
    if int(count) > 0:
        assert float((ref.poses - graph.poses).abs().max()) > 1e-2


def test_cpu_graphs_run_the_plain_version(monkeypatch):
    """On CPU tensors `assemble_window` is the plain version, bit for bit,
    and launches nothing (the kernel's wrapper refuses a CPU graph); the
    window solve asks for one system an iteration."""
    graph, count, W = window_case("loops")
    before = ws.KERNEL_LAUNCHES, ws.CAPTURED_LAUNCHES
    H, b = solver.assemble_window(graph, count, W)
    Hp, bp = solver.assemble_window_plain(graph, count, W)
    assert torch.equal(H, Hp) and torch.equal(b, bp)
    assert (ws.KERNEL_LAUNCHES, ws.CAPTURED_LAUNCHES) == before
    with pytest.raises(ValueError):
        ws.assemble(graph, count, W)
    calls = []
    real = solver.assemble_window
    monkeypatch.setattr(solver, "assemble_window",
                        lambda *a: calls.append(1) or real(*a))
    solver.solve_window_compact(graph, count, W, iterations=2)
    assert len(calls) == 2
