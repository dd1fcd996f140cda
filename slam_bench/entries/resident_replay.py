"""Entry `resident_replay`: the port's device-resident per-scan program
without the loop detector and the full correction
(`make_pipeline_replay_carry`, two captured CUDA graphs a scan), driven
chunk by chunk with the state carried from one chunk to the next.  A
chunk's scans complete together, when the device has finished them."""

from __future__ import annotations

import time

import torch

from slam_bench import check

UNIT = "chunk"


class Driver:
    def __init__(self, cell, inputs):
        from lio_slam_tpu_torch.pipeline import replay as rp

        self.cell = cell
        self.L = cell.traffic["loop_every"]
        self.chunk = rp.make_pipeline_replay_carry(cell.program_config,
                                                   device=cell.device)
        x = inputs
        n = (len(x.stamps) // self.L) * self.L
        self.chunks = [rp.ReplayBatch(
            xyz=x.xyz[a:a + self.L], ptime=x.ptime[a:a + self.L],
            pmask=x.pmask[a:a + self.L], ring=x.ring[a:a + self.L],
            acc=x.acc[a:a + self.L], gyr=x.gyr[a:a + self.L],
            dts=x.dts[a:a + self.L], rel_t=x.rel_t[a:a + self.L],
            imask=x.imask[a:a + self.L],
            stamp=x.stamps[a:a + self.L].to(torch.float32))
            for a in range(0, n, self.L)]
        self.state, self.fes = self.chunk.replay.init()
        self.last_pose = torch.zeros(6, dtype=torch.float32, device=cell.device)
        self.chunk.replay.capture(self.state, self.fes, self.chunks[0])
        self.poses, self.iters = [], []
        self.next = 0

    def units_left(self) -> int:
        return len(self.chunks) - self.next

    def advance(self) -> list:
        """One chunk: [(scan, handed in, completed)] for its scans."""
        first = self.next * self.L
        t0 = time.perf_counter()
        with torch.profiler.record_function("replay.scans"):
            self.state, self.fes, self.last_pose, outs = self.chunk(
                self.state, self.fes, self.last_pose, self.chunks[self.next])
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.poses.append(outs.poses)
        self.iters.append(outs.iters)
        self.next += 1
        return [(first + k, t0, t1) for k in range(self.L)]

    def counters(self) -> dict:
        return {}

    def iterations(self):
        return torch.cat(self.iters).cpu().numpy()

    def outputs(self, in_window) -> check.Outputs:
        n = self.next * self.L
        store = self.state.store
        c = int(store.count)
        kf = {check.scan_of(s) for s in store.stamps[:c].tolist()}
        return check.Outputs(
            poses=torch.cat(self.poses).double().cpu(),
            is_kf=torch.tensor([i in kf for i in range(n)]),
            in_window=torch.as_tensor(in_window[:n]),
            latency=torch.full((n,), float("nan"), dtype=torch.float64),
            snapshots=[], loops=[], corrections=[])

    def close(self):
        self.chunk = self.state = self.fes = None
        self.poses = self.iters = None
