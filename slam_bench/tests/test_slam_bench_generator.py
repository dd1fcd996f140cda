"""The traffic generator: the same seed gives the same inputs, every scan
holds its sensor's full count of returns, and the routes keep their stated
revisit and no-revisit property."""

import json

import pytest
import torch

from benchtree import BENCH
from slam_bench import generator


def _load(kind, name):
    return json.loads((BENCH / kind / f"{name}.json").read_text())


@pytest.mark.parametrize("config,returns", [("vlp16_default", 28800),
                                            ("os1_64_mulran", 65536)])
def test_every_scan_holds_the_full_count(config, returns):
    cfg = _load("configs", config)
    assert cfg["sensor"]["returns"] == returns
    x = generator.make_inputs(cfg, _load("traffic", "stream"), 2**40 + 3, 3,
                              torch.device("cpu"))
    assert x.xyz.shape == (3, returns, 3)
    assert bool(x.pmask.all())
    assert int(x.ring.min()) >= 0 and int(x.ring.max()) < cfg["sensor"]["beams"]
    assert float(x.ptime.min()) >= 0.0 and float(x.ptime.max()) <= generator.SCAN_PERIOD
    # scan 0 has no IMU; each later window holds 2 x rate x 0.1 s samples
    per = int(round(cfg["imu"]["rate_hz"] * generator.SCAN_PERIOD))
    assert int(x.imask[0].sum()) == 0
    assert [int(n) for n in x.imask[1:].sum(1)] == [2 * per] * 2


def test_same_seed_same_scans_other_seed_other_scans():
    cfg, tr = _load("configs", "vlp16_default"), _load("traffic", "stream")
    cfg = dict(cfg, sensor=dict(cfg["sensor"], returns=2048))
    dev = torch.device("cpu")
    a = generator.make_inputs(cfg, tr, 2**33 + 1, 3, dev)
    b = generator.make_inputs(cfg, tr, 2**33 + 1, 3, dev)
    c = generator.make_inputs(cfg, tr, 2**33 + 2, 3, dev)
    for fa, fb in zip(a, b):
        assert torch.equal(fa, fb)
    assert not torch.equal(a.xyz, c.xyz)
    # every seed drives the same route with the same sizes
    assert torch.equal(a.truth, c.truth) and a.xyz.shape == c.xyz.shape


def _positions(traffic, n):
    route = generator.make_route(traffic, (n + 2) * generator.SCAN_PERIOD,
                                 torch.device("cpu"))
    stamps = torch.arange(n, dtype=torch.float64) * generator.SCAN_PERIOD
    return generator.route_at(route, stamps)[1], stamps


def test_open_routes_never_revisit():
    for name in ("stream", "resident_drive"):
        tr = _load("traffic", name)
        n = tr["warmup_scans"] + int(51 * tr["max_scans_per_s"])
        pos, stamps = _positions(tr, n)
        assert not bool(generator.revisits(pos, stamps, 15.0, 30.0).any())


# a circuit mix as a revisit cell would give it: a circle of 12 m at
# 2 m/s (a lap 37.7 s), the first lap run before the window
CIRCUIT = {"route": "circuit", "speed_mps": 2.0, "ramp_s": 0.5, "height_m": 1.8,
           "radius_m": 12.0, "warmup_scans": 380, "max_scans_per_s": 40.0}


def test_circuit_revisits_only_after_its_first_lap():
    tr = CIRCUIT
    n = tr["warmup_scans"] + int(51 * tr["max_scans_per_s"])
    pos, stamps = _positions(tr, n)
    rev = generator.revisits(pos, stamps, 15.0, 30.0)
    lap = 2 * 3.141592653589793 * tr["radius_m"] / tr["speed_mps"]
    assert lap > 30.0
    # the window (after the pre-roll lap) revisits on every scan
    assert bool(rev[tr["warmup_scans"]:].all())
    # within 30 s of the start nothing can be a revisit
    assert not bool(rev[:300].any())
