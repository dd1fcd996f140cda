"""The harness builds a cell from files dropped into a directory, without
an edit to any file already there: a new configuration, traffic mix,
entry, per-layer metric and limits.  The new entry feeds the generator's
truth as the program's answers, so the run also shows the reference
accepting the true trajectory and refusing one whose odd scans are moved
by 0.5 m.  (The
truth is not the registration's optimum to the centimetre: LIO-SAM's
deskew takes out the sweep's rotation and leaves its 0.2 m of travel,
so the limit here is 0.1 m.)"""

import json
import math
import time

import pytest
import torch

from benchtree import small_tree
from slam_bench import harness

TRUTH_ENTRY = '''
import time
import torch
from slam_bench import check, reference as ref

UNIT = "scan"


class Driver:
    """The generator's truth, in the frame of the first pose, as the
    program's answers; keyframes by the plain gate."""

    def __init__(self, cell, inputs):
        T = ref.inverse(inputs.truth[0]) @ inputs.truth
        self.poses = torch.cat([ref.matrix_rpy(T[:, :3, :3]), T[:, :3, 3]], 1)
        self.poses[1::2, 3:] += cell.traffic.get("offset_m", 0.0)   # odd scans
        self.params, self.next = cell.params, 0

    def units_left(self):
        return len(self.poses) - self.next

    def advance(self):
        i, t = self.next, time.perf_counter()
        self.next += 1
        return [(i, t, t + 1e-3)]

    def counters(self):
        return {}

    def iterations(self):
        return torch.zeros(self.next)

    def outputs(self, in_window):
        n = self.next
        kf, last = torch.zeros(n, dtype=torch.bool), None
        for i in range(n):
            P = ref.pose_matrix(self.poses[i])
            if last is None or ref.keyframe_due(self.params, last, P, margin=0.0):
                kf[i], last = True, P
        return check.Outputs(poses=self.poses[:n], is_kf=kf, in_window=in_window,
                             latency=torch.full((n,), float("nan")),
                             snapshots=[], loops=[], corrections=[])

    def close(self):
        pass
'''

METRIC = '''
UNIT = "scans"


def read(rec):
    return len(rec["records"])
'''


def _drop_cell(tmp, offset):
    root = small_tree(tmp)
    bench = root / "slam_bench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "vlp16_default.json").read_text())
    cfg["name"] = "vlp16_truth"
    (bench / "configs" / "vlp16_truth.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "stream.json").read_text())
    tr.update(entry="truth_feed", warmup_scans=15, max_scans_per_s=30.0, offset_m=offset)
    (bench / "traffic" / "truth.json").write_text(json.dumps(tr))
    (bench / "entries" / "truth_feed.py").write_text(TRUTH_ENTRY)
    (bench / "metrics" / "truth_scans.py").write_text(METRIC)
    (bench / "limits" / "vlp16_truth.truth.json").write_text(json.dumps(
        {"limits": {"pose_gap_mean_m": 0.1}}))
    spec["configs"].append({"name": "vlp16_truth", "source": "test",
                            "file": "slam_bench/configs/vlp16_truth.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "vlp16_truth.truth", "config": "vlp16_truth",
                              "traffic": "truth", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "truth_scans", "unit": "scans", "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": "scans_per_s", "workloads": ["vlp16_truth.truth"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("offset,correct", [(0.0, True), (0.5, False)])
def test_a_cell_made_of_new_files_runs_and_is_judged(tmp_path, offset, correct):
    root = _drop_cell(tmp_path, offset)
    for trace in (False, True):
        cell = harness.load_cell(root / "BENCHMARK.json", root / "slam_bench",
                                 "vlp16_truth.truth", trace, "cpu")
        names = [m for m, _ in cell.metrics]
        assert ("truth_scans" in names) == trace and ("scans_per_s" in names) != trace
    cell = harness.load_cell(root / "BENCHMARK.json", root / "slam_bench",
                             "vlp16_truth.truth", False, "cpu")
    res = harness.run_cell(cell, 2**41 + 7, 1.0, False, time.perf_counter())
    assert list(res)[-1] == "checks"
    # every scan made for the window (whole cadences of 10) is fed in it
    assert res["attempted"] == harness.scans_needed(cell.traffic, 1.0) - 15
    assert res["failed"] == 0
    assert res["metrics"]["scans_per_s"]["unit"] == "scans/s"
    gap = res["checks"]["pose_gap_mean_m"]["value"]
    assert math.isfinite(gap)
    assert res["correct"] is correct, res["checks"]


def test_run_refuses_without_the_card(monkeypatch, capsys):
    import importlib.util

    from benchtree import BENCH

    spec = importlib.util.spec_from_file_location("slam_bench_run", BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "vlp16_default.stream", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
