"""Runs of the cells at test size on the CPU, the harness's look for a
card skipped, with the timed path broken underneath: `correct` comes out
false for each fault a cell can have.  Both cells run the same step
(`make_lio_step`), which each fault wraps: a step that returns its state
unchanged and an answer altered where it is produced (the stream), and a
keyframe store that is never written, the masked save of the resident
program gone (the drive, whose keyframe flags are read from that store).
That the sound program comes out true is shown at the cells' own size on
the card (`test_slam_bench_control.py`, marker `cuda`): at this size the
CPU's window holds three scans (a chunk on the drive), too few to judge
the sound program by a mean."""

import json
import time

import pytest
import torch

from benchtree import small_tree
from slam_bench import harness

LIMITS = {"pose_gap_mean_m": 0.03, "scans_unjudged": 0, "keyframe_mismatches": 0}


def _frozen(real):
    def make(*a, **k):
        step = real(*a, **k)

        def frozen(state, inp):
            _, out = step(state, inp)
            return state, out
        return frozen
    return make


def _altered(real):
    def make(*a, **k):
        step = real(*a, **k)

        def altered(state, inp):
            state, out = step(state, inp)
            shift = torch.tensor([0, 0, 0, 0.3, 0, 0], dtype=state.pose.dtype,
                                 device=state.pose.device)
            return state._replace(pose=state.pose + shift), out
        return altered
    return make


def _store_kept(real):
    def make(*a, **k):
        step = real(*a, **k)

        def kept(state, inp):
            store = type(state.store)(*(t.clone() if torch.is_tensor(t) else t
                                        for t in state.store))
            state, out = step(state, inp)
            return state._replace(store=store), out
        return kept
    return make


@pytest.mark.parametrize("workload,fault", [
    ("vlp16_default.stream", "frozen"), ("vlp16_default.stream", "altered"),
    ("os1_64_mulran.resident_drive", "store_kept")])
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, workload, fault):
    from lio_slam_tpu_torch.pipeline import lio

    root = small_tree(tmp_path, returns=16384)
    lim = root / "slam_bench" / "limits" / f"{workload}.json"
    lim.write_text(json.dumps({"limits": LIMITS}))
    # inputs for three window scans (a chunk on the drive): the window ends
    # when they run out, however slowly this CPU runs them
    for f in (root / "slam_bench" / "traffic").glob("*.json"):
        tr = json.loads(f.read_text())
        f.write_text(json.dumps(dict(tr, max_scans_per_s=0.05)))
    wrap = {"frozen": _frozen, "altered": _altered, "store_kept": _store_kept}[fault]
    monkeypatch.setattr(lio, "make_lio_step", wrap(lio.make_lio_step))
    cell = harness.load_cell(root / "BENCHMARK.json", root / "slam_bench",
                             workload, False, "cpu")
    res = harness.run_cell(cell, 2**42 + 11, 60.0, False, time.perf_counter())
    assert res["attempted"] >= 2
    assert res["correct"] is False, res["checks"]
