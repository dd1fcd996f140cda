"""The readings that the check's limits are set from: for each seed, the
program's numbers (the lower readings) and the numbers of the controls,
the reference put in the program's place in a lower precision (the upper
readings).  The benchmark's own runs do not run this.

    python3 slam_bench/control.py --workload <cell> --seeds 11,12,13 --seconds 10 [--prec bf16,tf32]

Each seed runs the program on the cell's traffic for `--seconds` (a short
window at the cell's own load), then judges the program's answers and
each control's.  A control answers what the program answered, one step at
a time from the program's own previous state: each checked scan's pose is
its registration from the previous published pose onto its map, the
keyframe flags are the gate computed in its precision on its rounded
poses, and each loop is its verification from the detector's guess (the
current keyframe's pose).  One JSON line a seed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))

import torch  # noqa: E402

from slam_bench import check  # noqa: E402
from slam_bench import reference as ref  # noqa: E402


def _gate(params: dict, prec: ref.Precision):
    """saveFrame's gate computed in `prec`: the poses as it keeps them,
    the relative motion from rounded operands, no margin."""
    def due(last, pose):
        a, b = prec.store(last), prec.store(pose)
        D = prec.product(ref.inverse(a)) @ prec.product(b)
        ang = prec.product(ref.matrix_rpy(D[:3, :3])).abs()
        dist = float(prec.product(torch.linalg.norm(prec.product(D[:3, 3]))))
        return (bool((ang >= params["angle_threshold"]).any())
                or dist >= params["dist_threshold"])
    return due


def control_outputs(params: dict, inputs, out: check.Outputs, seed: int,
                    prec_name: str, n_random=12, n_slow=4) -> check.Outputs:
    """`out` with the control's answers in the program's place."""
    judge = check.Judge(params, inputs, prec_name)
    prec = judge.prec
    dev = inputs.xyz.device
    poses = out.poses.clone()
    for i in check.checked_scans(out, seed, n_random, n_slow):
        T_prev = ref.pose_matrix(out.poses[i - 1].to(dev))
        m = judge.local_map(judge.keyframe_poses(out, i), T_prev)
        if m is None:
            continue
        T = ref.register(params, judge.prep(i), m, T_prev, prec)[0]
        poses[i] = torch.cat([ref.matrix_rpy(T[:3, :3]), T[:3, 3]]).cpu().to(poses.dtype)
    # the control's keyframe flags over the window, along its own keyframes
    due = _gate(params, prec)
    is_kf = out.is_kf.clone()
    last = None
    for i in range(len(is_kf)):
        if bool(out.in_window[i]) and last is not None:
            is_kf[i] = due(ref.pose_matrix(check.Judge.pose_as_of(out, last, i)),
                           ref.pose_matrix(poses[i]))
        if bool(is_kf[i]):
            last = i
    loops = []
    for loop in out.loops:
        stamps = [check.scan_of(s) for s in loop["stamps"].tolist()]
        cur, cand = check.scan_of(loop["cur"]), check.scan_of(loop["cand"])
        T_cur = ref.pose_matrix(loop["poses"][stamps.index(cur)].to(dev))
        T_cand = ref.pose_matrix(loop["poses"][stamps.index(cand)].to(dev))
        T = ref.register(params, judge.prep(cur), judge.submap(loop, cand),
                         T_cur, prec)[0]
        meas = ref.inverse(T) @ T_cand
        loops.append({**loop, "meas": torch.cat([ref.matrix_rpy(meas[:3, :3]),
                                                 meas[:3, 3]]).cpu()})
    return out._replace(poses=poses, is_kf=is_kf, loops=loops)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--prec", default="bf16,tf32")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from slam_bench import harness

    cell = harness.load_cell(BENCH.parent / "BENCHMARK.json", BENCH,
                             args.workload, False, args.device)
    limits = {k: float("inf") for k in cell.limits}
    for seed in (int(s) for s in args.seeds.split(",")):
        inputs, rec, _ = harness.run_window(cell, seed, args.seconds, False,
                                            time.perf_counter())
        out = rec["outputs"]
        row = {"seed": seed, "scans": len(rec["records"]),
               "loops": len(out.loops), "corrections": len(out.corrections),
               "program": check.judge_run(cell.params, inputs, out, seed, limits)}
        for name in args.prec.split(","):
            ctl = control_outputs(cell.params, inputs, out, seed, name)
            row[name] = check.judge_run(cell.params, inputs, ctl, seed, limits)
        print(json.dumps(row), flush=True)
        del inputs, rec, out
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
