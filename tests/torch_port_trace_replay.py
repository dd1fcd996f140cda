"""Trace where the carried pipeline replay parts from the JAX reference.

Runs the JAX `HostDrivenReplay` (its fused path with the Pallas kernel in
interpret mode, as `torch_port_make_fixture.py replay` ran the monolith)
and the port's eager `HostDrivenReplay` on the CPU over the first scans of
`synthetic_mission.pipeline_replay_inputs()`, the port with the JAX
front-end's state carried in from `fixtures/pipeline_replay_jax.npz`, and
compares the two going into the last scan: the GN iterations and keyframe
flags of the scans before it, the keyframe gate's distance from the last
keyframe where a flag differs, the initial guess, the map grid's counts and
table, and the stored keyframe poses.

    JAX_PLATFORMS=cpu python tests/torch_port_trace_replay.py [scans=61]

About 2 minutes at 61 scans.  It is not a test (pytest does not collect it).
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from lio_slam_tpu import config as jax_config  # noqa: E402
from lio_slam_tpu.ops import registration as jreg  # noqa: E402
from lio_slam_tpu.pipeline import lio as jlio  # noqa: E402
from lio_slam_tpu.pipeline import replay as jreplay  # noqa: E402
from lio_slam_tpu_torch.pipeline import lio as tlio  # noqa: E402
from lio_slam_tpu_torch.pipeline import replay as treplay  # noqa: E402
from lio_slam_tpu_torch.pipeline import synthetic_mission as sm  # noqa: E402
from lio_slam_tpu_torch.utils import se3  # noqa: E402
from torch_port_helpers import jax_fused_interpret, n, to_jax_config  # noqa: E402

FIXTURE = os.path.join(ROOT, "lio_slam_tpu_torch", "fixtures",
                       "pipeline_replay_jax.npz")


def recording(step, rows, last, guess_of):
    """`step` that appends each scan's keyframe flag, GN iterations, pose
    and keyframe count to `rows`, and keeps the state and initial guess
    going into scan `last`."""
    def wrapped(state, sin):
        row = {}
        if len(rows) == last:
            row["state"] = jax.tree.map(n, state)
            row["guess"] = n(guess_of(state, sin))
        state, out = step(state, sin)
        row.update(is_kf=bool(out.is_keyframe), iters=int(out.registration_iters),
                   pose=n(state.pose), count=int(state.store.count))
        rows.append(row)
        return state, out
    return wrapped


def jax_run(cfg, batch, last):
    jreg._maybe_fused = jax_fused_interpret
    hd = jreplay.HostDrivenReplay(to_jax_config(cfg, jax_config),
                                  loop_every=sm.LOOP_EVERY)
    rows = []
    hd.step = recording(hd.step, rows, last, jlio._update_initial_guess)
    hd.run(*hd.init(), hd.split(jreplay.ReplayBatch(
        *(jnp.asarray(a) for a in batch))))
    return rows


def port_run(cfg, batch, last, fixture):
    hd = treplay.HostDrivenReplay(cfg, loop_every=sm.LOOP_EVERY, device="cpu")
    rows = []
    hd.step = recording(hd.step, rows, last, tlio._update_initial_guess)

    def carried(fn):
        calls = iter(range(last + 1))
        return lambda fes, *a, **k: fn(chip_smoke.fixture_imu_state(
            fixture, next(calls), hd.device), *a, **k)

    hd._prep_predict = carried(hd._prep_predict)
    hd.correct = carried(hd.correct)
    hd.run(*hd.init(), hd.split(batch))
    return rows


def gate_distance(rows, i):
    """Distance and largest angle of scan i's pose from the keyframe
    before it (the keyframe gate's inputs)."""
    k = max(j for j in range(i) if rows[j]["is_kf"])
    rel = n(se3.pose6_between(torch.from_numpy(rows[k]["pose"]),
                              torch.from_numpy(rows[i]["pose"])))
    return k, float(np.linalg.norm(rel[3:])), float(np.abs(rel[:3]).max())


def main():
    scans = int(sys.argv[1]) if len(sys.argv) > 1 else 61
    last = scans - 1
    fixture = dict(np.load(FIXTURE))
    cfg = sm.bench_config()
    _, batch = sm.pipeline_replay_inputs()
    batch = type(batch)(*(a[:scans] for a in batch))
    ref = jax_run(cfg, batch, last)
    got = port_run(cfg, batch, last, fixture)
    iters_ref = [r["iters"] for r in ref]
    print("JAX replay against the fixture's monolith: GN iterations differ "
          "at", [i for i in range(scans)
                 if iters_ref[i] != fixture["registration_iters"][i]])
    kf = lambda rows: [i for i in range(last) if rows[i]["is_kf"]]
    print(f"keyframes before scan {last}: JAX {kf(ref)}, port {kf(got)}")
    print(f"GN iterations part at {[i for i in range(scans) if ref[i]['iters'] != got[i]['iters']]}")
    thr = cfg.keyframe
    for i in range(1, last):
        if ref[i]["is_kf"] != got[i]["is_kf"]:
            kj, dj, aj = gate_distance(ref, i)
            kp, dp, ap = gate_distance(got, i)
            print(f"scan {i}: keyframe JAX {ref[i]['is_kf']} / port "
                  f"{got[i]['is_kf']}, GN iterations {ref[i]['iters']} / "
                  f"{got[i]['iters']}; from keyframe {kj} / {kp}: "
                  f"{dj:.6f} / {dp:.6f} m (gate {thr.dist_threshold}), "
                  f"{aj:.6f} / {ap:.6f} rad (gate {thr.angle_threshold})")
    sj, sp = ref[last]["state"], got[last]["state"]
    print(f"initial guess of scan {last}: max difference "
          f"{np.abs(ref[last]['guess'] - got[last]['guess']).max():.3e}; "
          f"pose going in {np.abs(sj.pose - sp.pose).max():.3e}")
    cj, cp = np.asarray(sj.map_grid.counts), np.asarray(sp.map_grid.counts)
    tj, tp = np.asarray(sj.map_grid.table), np.asarray(sp.map_grid.table)
    rows_apart = int((np.abs(tj - tp).max(axis=(1, 2)) > 1e-4).sum())
    print(f"map grid: counts differ in {int((cj != cp).sum())} of {len(cj)} "
          f"buckets (points {int(cj.sum())} / {int(cp.sum())}); {rows_apart} "
          f"table rows differ by more than 1e-4 m")
    k = int(sj.store.count)
    print(f"keyframes stored {k} / {int(sp.store.count)}; their poses differ "
          f"by up to {np.abs(sj.store.poses[:k] - sp.store.poses[:k]).max(axis=0)}")


if __name__ == "__main__":
    main()
