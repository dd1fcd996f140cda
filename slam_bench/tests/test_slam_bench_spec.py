"""BENCHMARK.json keeps to its format (keys, names, lengths, bounds), and
every name in it has its file."""

import json
import re

from benchtree import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_lengths():
    spec = _spec()
    assert set(spec) == TOP
    assert spec["paths"] == ["slam_bench"] and 1 <= spec["run_seconds"] <= 51
    assert all(_line(w) for w in spec["command"])
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and c["file"].startswith("slam_bench/")
        names.append(c["name"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"]) and w["config"] in names
        names.append(w["name"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source",
                                          "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    spec = _spec()
    for w in spec["workloads"]:
        ok = lambda m: w["name"] in m.get("workloads", [w["name"]])
        e2e = [m["name"] for m in spec["end_to_end"] if ok(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(ok(m) for m in spec["per_layer"])


def test_every_name_has_its_file():
    spec = _spec()
    for c in spec["configs"]:
        cf = json.loads((ROOT / c["file"]).read_text())
        assert cf["name"] == c["name"] and cf["source"] == c["source"]
        assert cf["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        tr = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "entries" / f"{tr['entry']}.py").exists()
        lim = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        assert lim["limits"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_the_configs_run_as_their_files_state():
    from slam_bench import harness

    for c in _spec()["configs"]:
        cfg = harness.program_config(json.loads((ROOT / c["file"]).read_text()))
        assert cfg.static.max_keyframes == 2048 and cfg.static.max_scan_points == 16384
