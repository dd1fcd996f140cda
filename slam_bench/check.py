"""The comparison that decides `correct`.

The program's answers are its published poses, its keyframe flags and
the loops it accepted.  The reference (`reference.py`) judges each by what
it says:

- `pose_gap_mean_m`: for a sample of the window's scans drawn from the
  seed (with the slowest ones in it), the mean distance from the
  program's pose to the reference's registration optimum of that scan,
  started from the program's pose, against the map made of the keyframes
  saved before it at their poses as of that scan (the largest gap, in
  metres and degrees, is printed beside it);
- `scans_unjudged`: the sampled scans that had no map to be judged
  against, because no keyframe was saved before them within the map's
  radius (an answer that never came: every scan after the first has
  one), or 1 where the window holds no scan to sample;
- `keyframe_mismatches`: the window's scans whose keyframe flag differs
  from LIO-SAM's gate applied to the published poses against the last
  keyframe (motions within 1e-4 of a threshold are not judged), and scan
  0 where it is not a keyframe (LIO-SAM always saves the first scan, and
  the gate is judged from it whatever the program flagged);
- where loops were accepted, each one's verified pose of the current
  keyframe against the reference's registration of that keyframe onto the
  candidate's submap (`loop_gap_m`), and its measurement against the
  generator's true relative pose (the last column of `loops`).

Each number is printed beside its limit (`limits/<cell>.json`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from slam_bench import reference as ref

SCAN_PERIOD = 0.1
MAP_KEYFRAMES = 40           # nearest keyframes within the radius a map holds


class Outputs(NamedTuple):
    """What the program produced, on the host, for every scan it
    processed (warm-up included).  Snapshots are the keyframe store as a
    later scan saw it: after a full correction (`after` = the last scan
    before it), or at a detector cycle."""

    poses: torch.Tensor          # (N, 6) published pose6
    is_kf: torch.Tensor          # (N,) bool
    in_window: torch.Tensor      # (N,) bool
    latency: torch.Tensor        # (N,) s, NaN where not timed one by one
    snapshots: list              # [{"after": i, "stamps": (k,), "poses": (k, 6)}]
    loops: list                  # [{"after": i, "cur": stamp, "cand": stamp,
                                 #   "meas": (6,), "stamps": (k,), "poses": (k, 6)}]
    corrections: list            # scan index after which a correction solved


def scan_of(stamp) -> int:
    return int(round(float(stamp) / SCAN_PERIOD))


class Judge:
    """The reference over one run's inputs (`generator.Inputs`, on the
    device) and the configuration's parameters."""

    def __init__(self, params: dict, inputs, prec: str = "float64"):
        self.params = params
        self.inputs = inputs
        self.prec = ref.precision(prec)
        self._prep = {}

    def prep(self, i: int) -> torch.Tensor:
        if i not in self._prep:
            x = self.inputs
            self._prep[i] = ref.prep_scan(self.params, x.xyz[i], x.ptime[i],
                                          x.ring[i], x.gyr[i], x.rel_t[i],
                                          x.imask[i], self.prec)
        return self._prep[i]

    @staticmethod
    def pose_as_of(out: Outputs, j: int, i: int) -> torch.Tensor:
        """Keyframe j's pose6 as scan i saw it: its pose in the newest
        snapshot taken before i, else its published pose."""
        p = out.poses[j]
        for snap in out.snapshots:
            if snap["after"] >= i:
                break
            if "index" not in snap:
                snap["index"] = {scan_of(s): k for k, s in
                                 enumerate(snap["stamps"].tolist())}
            k = snap["index"].get(j)
            if k is not None:
                p = snap["poses"][k]
        return p

    def keyframe_poses(self, out: Outputs, i: int) -> dict:
        """{scan index: (4, 4) pose on the device} of the keyframes saved
        before scan i, each as of scan i."""
        dev = self.inputs.xyz.device
        return {j: ref.pose_matrix(self.pose_as_of(out, j, i).to(dev))
                for j in torch.nonzero(out.is_kf[:i]).flatten().tolist()}

    def local_map(self, kfs: dict, T: torch.Tensor) -> torch.Tensor:
        """The surface map about pose T: the nearest MAP_KEYFRAMES within
        the surrounding radius, merged and voxel-downsampled."""
        if not kfs:
            return None
        idx = list(kfs)
        pos = torch.stack([kfs[j][:3, 3] for j in idx])
        d = torch.linalg.norm(pos - T[:3, 3], dim=1)
        order = torch.argsort(d)[:MAP_KEYFRAMES]
        pts = []
        for k in order.tolist():
            if float(d[k]) > self.params["surrounding_radius"]:
                continue
            Tk = kfs[idx[k]]
            pts.append(self.prep(idx[k]) @ Tk[:3, :3].T + Tk[:3, 3])
        if not pts:
            return None
        return self.prec.store(ref.voxel_centroids(torch.cat(pts),
                                                   self.params["surf_leaf"]))

    def registered(self, out: Outputs, i: int, T0: torch.Tensor):
        """The reference's optimum for scan i from T0, or None where scan i
        has no map."""
        m = self.local_map(self.keyframe_poses(out, i), T0)
        if m is None:
            return None
        return ref.register(self.params, self.prep(i), m, T0, self.prec)[0]

    def submap(self, loop: dict, cand: int) -> torch.Tensor:
        """loopFindNearKeyframes: the candidate's keyframe and `search_num`
        on either side in store order, at the store's poses then."""
        dev = self.inputs.xyz.device
        stamps = loop["stamps"].tolist()
        slot = [scan_of(s) for s in stamps].index(cand)
        n = self.params["loop_search_num"]
        pts = []
        for k in range(max(0, slot - n), min(len(stamps), slot + n + 1)):
            Tk = ref.pose_matrix(loop["poses"][k].to(dev))
            pts.append(self.prep(scan_of(stamps[k])) @ Tk[:3, :3].T + Tk[:3, 3])
        return self.prec.store(ref.voxel_centroids(torch.cat(pts),
                                                   self.params["surf_leaf"]))

    def loop_pose(self, loop: dict) -> torch.Tensor:
        """The current keyframe's pose that the loop's measurement states:
        T_cand * meas^-1 (meas = T_cur^-1 T_cand)."""
        dev = self.inputs.xyz.device
        cand = scan_of(loop["cand"])
        slot = [scan_of(s) for s in loop["stamps"].tolist()].index(cand)
        Tc = ref.pose_matrix(loop["poses"][slot].to(dev))
        return Tc @ ref.inverse(ref.pose_matrix(loop["meas"].to(dev)))


def checked_scans(out: Outputs, seed: int, n_random: int, n_slow: int) -> list:
    """The window's scans the pose check registers again: the `n_slow`
    slowest, where scans are timed one by one, and `n_random` drawn from
    the seed."""
    win = torch.nonzero(out.in_window).flatten()
    win = win[win > 0]
    chosen = []
    lat = out.latency[win]
    if torch.isfinite(lat).any():
        chosen += win[torch.argsort(lat, descending=True)[:n_slow]].tolist()
    g = torch.Generator().manual_seed(int(seed) % (2 ** 63))
    perm = torch.randperm(len(win), generator=g)
    chosen += win[perm[:n_random]].tolist()
    return sorted(set(chosen))


def keyframe_mismatches(judge: Judge, out: Outputs) -> int:
    """Scans of the window whose flag LIO-SAM's gate contradicts, the gate
    judged from scan 0, and scan 0 where it is not a keyframe."""
    n = 0 if bool(out.is_kf[0]) else 1
    last_kf = 0
    for i in range(1, len(out.is_kf)):
        if bool(out.in_window[i]):
            last = ref.pose_matrix(judge.pose_as_of(out, last_kf, i))
            due = ref.keyframe_due(judge.params, last, ref.pose_matrix(out.poses[i]))
            if due is not None and due != bool(out.is_kf[i]):
                n += 1
        if bool(out.is_kf[i]):
            last_kf = i
    return n


def judge_run(params: dict, inputs, out: Outputs, seed: int, limits: dict,
              n_random: int = 12, n_slow: int = 4) -> dict:
    """{number: (value, limit)} of the run, and whether every number is
    within its limit (`correct`)."""
    judge = Judge(params, inputs)
    dev = inputs.xyz.device
    gaps_m, gaps_deg = [], []
    chosen = checked_scans(out, seed, n_random, n_slow)
    for i in chosen:
        P = ref.pose_matrix(out.poses[i].to(dev))
        R = judge.registered(out, i, P)
        if R is None:
            continue
        g_m, g_deg = ref.pose_gap(P, R)
        gaps_m.append(g_m)
        gaps_deg.append(g_deg)
    numbers = {"pose_gap_mean_m": sum(gaps_m) / max(len(gaps_m), 1),
               "pose_gap_max_m": max(gaps_m, default=0.0),
               "pose_gap_max_deg": max(gaps_deg, default=0.0),
               "scans_judged": len(gaps_m),
               # a window with no scan to draw from has judged nothing
               "scans_unjudged": len(chosen) - len(gaps_m) if chosen else 1,
               "keyframe_mismatches": keyframe_mismatches(judge, out)}
    if out.loops:
        lm, ld, each = [0.0], [0.0], []
        for loop in out.loops:
            T = judge.loop_pose(loop)
            m = judge.submap(loop, scan_of(loop["cand"]))
            R, passes, used = ref.register(params, judge.prep(scan_of(loop["cur"])),
                                           m, T, judge.prec)
            g_m, g_deg = ref.pose_gap(T, R)
            lm.append(g_m)
            ld.append(g_deg)
            stamps = [scan_of(s) for s in loop["stamps"].tolist()]
            sep = float(torch.linalg.norm(
                loop["poses"][stamps.index(scan_of(loop["cur"]))][3:]
                - loop["poses"][stamps.index(scan_of(loop["cand"]))][3:]))
            # the generator's truth as a second witness: the measurement
            # against the true relative pose of the two scans
            tr = inputs.truth
            true_rel = ref.inverse(tr[scan_of(loop["cur"])]) @ tr[scan_of(loop["cand"])]
            t_m, _ = ref.pose_gap(true_rel, ref.pose_matrix(loop["meas"].to(dev)))
            each.append([scan_of(loop["cur"]), scan_of(loop["cand"]), round(sep, 3),
                         round(g_m, 4), round(g_deg, 4), passes, used, round(t_m, 4)])
        numbers.update(loop_gap_m=max(lm), loop_gap_deg=max(ld),
                       loops_judged=len(out.loops), loops=each)
    checks = {k: (v, limits[k]) for k, v in numbers.items() if k in limits}
    info = {k: v for k, v in numbers.items() if k not in limits}
    ok = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    return {"correct": ok, "checks": checks, "info": info}
