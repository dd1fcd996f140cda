"""Entry `runner`: `Runner.process_scan`, the port's live path, fed one
scan at a time as a bag replay feeds it (closed loop), every result read
back to the host before the next scan is handed in (`fetch_every=1`)."""

from __future__ import annotations

import time

import numpy as np
import torch

from slam_bench import check

UNIT = "scan"


class Driver:
    def __init__(self, cell, inputs):
        from lio_slam_tpu_torch.io import formats
        from lio_slam_tpu_torch.pipeline.runner import Runner

        self.runner = Runner(cell.program_config, device=cell.device,
                             loop_every=cell.traffic["loop_every"], fetch_every=1)
        # the host's copy of each scan and IMU window, as a bag feed hands
        # them over
        x = inputs
        xyz, ptime, ring = x.xyz.cpu().numpy(), x.ptime.cpu().numpy(), x.ring.cpu().numpy()
        acc, gyr, quat = x.acc.cpu().numpy(), x.gyr.cpu().numpy(), x.quat.cpu().numpy()
        rel, imask, stamps = x.rel_t.cpu().numpy(), x.imask.cpu().numpy(), x.stamps.cpu().numpy()
        nine_axis = cell.program_config.imu.imu_type == 1
        self.scans, self.imus = [], []
        for i in range(len(stamps)):
            n = xyz.shape[1]
            self.scans.append(formats.StandardScan(
                xyz=xyz[i], intensity=np.zeros(n, np.float32),
                ring=ring[i].astype(np.uint16), time=ptime[i],
                stamp=float(stamps[i])))
            w = imask[i]
            imu = None
            if w.any():
                imu = {"acc": acc[i][w], "gyr": gyr[i][w],
                       "stamps": float(stamps[i]) + rel[i][w].astype(np.float64)}
                if nine_axis:
                    imu["quat"] = quat[i][w]
            self.imus.append(imu)
        self.next = 0
        n = len(stamps)
        self.poses = np.zeros((n, 6), np.float32)
        self.is_kf = np.zeros(n, bool)
        self.iters = np.zeros(n, np.int64)
        self.latency = np.full(n, np.nan)
        self.snapshots, self.loops, self.corrections = [], [], []

    def units_left(self) -> int:
        return len(self.scans) - self.next

    def _snapshot(self, after: int):
        st = self.runner.state.store
        return {"after": after, "count": st.count.clone(),
                "stamps": st.stamps.clone(), "poses": st.poses.clone()}

    def advance(self) -> list:
        """One scan: [(scan, handed in, pose on the host)]."""
        r, i = self.runner, self.next
        n_corr = len(r.full_correction_scans)
        t0 = time.perf_counter()
        with torch.profiler.record_function("runner.process_scan"):
            res = r.process_scan(self.scans[i], imu=self.imus[i])
        t1 = time.perf_counter()
        self.next += 1
        self.poses[i], self.is_kf[i] = res.pose, res.is_keyframe
        self.iters[i], self.latency[i] = int(res.registration_iters), t1 - t0
        if len(r.full_correction_scans) > n_corr:
            self.corrections.append(i)
            self.snapshots.append(self._snapshot(i))
        aux = r.last_loop_aux if r.scan_count % r.loop_every == 0 else None
        if aux is not None and bool(np.any(aux["loop_accepted"])):
            st = r.state
            for k in np.nonzero(aux["loop_accepted"])[0]:
                self.loops.append({
                    "after": i, "slot_i": int(aux["loop_pair_i"][k]),
                    "slot_j": int(aux["loop_pair_j"][k]),
                    "pend_i": st.pend_i.clone(), "pend_j": st.pend_j.clone(),
                    "pend_meas": st.pend_meas.clone(),
                    "pend_mask": st.pend_mask.clone(),
                    "stamps": st.store.stamps.clone(),
                    "poses": st.store.poses.clone(), "count": st.store.count.clone()})
        return [(i, t0, t1)]

    def counters(self) -> dict:
        """The Runner's own spans: each StageTimer stage's total seconds."""
        return {k: v.total for k, v in self.runner.timer.stats.items()}

    def iterations(self):
        return self.iters

    def outputs(self, in_window) -> check.Outputs:
        n = self.next
        return check.Outputs(
            poses=torch.from_numpy(self.poses[:n]), is_kf=torch.from_numpy(self.is_kf[:n]),
            in_window=torch.as_tensor(in_window[:n]),
            latency=torch.from_numpy(self.latency[:n]),
            snapshots=[_trim(s) for s in self.snapshots],
            loops=[_loop(l) for l in self.loops], corrections=list(self.corrections))

    def close(self):
        self.runner.close()
        self.runner = None


def _trim(s: dict) -> dict:
    c = int(s["count"])
    return {"after": s["after"], "stamps": s["stamps"][:c].double().cpu(),
            "poses": s["poses"][:c].double().cpu()}


def _loop(l: dict) -> dict:
    """A queued loop, as the reference reads it: the current and candidate
    keyframes' stamps, the measurement, and the store then."""
    c = int(l["count"])
    hit = (l["pend_mask"] & (l["pend_i"] == l["slot_i"])
           & (l["pend_j"] == l["slot_j"]))
    k = int(torch.nonzero(hit).flatten()[-1])
    return {"after": l["after"], "cur": float(l["stamps"][l["slot_i"]]),
            "cand": float(l["stamps"][l["slot_j"]]),
            "meas": l["pend_meas"][k].double().cpu(),
            "stamps": l["stamps"][:c].double().cpu(),
            "poses": l["poses"][:c].double().cpu()}
