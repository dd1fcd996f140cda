"""The benchmark of lio_slam_tpu_torch: one run of one cell.

    python3 slam_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It makes the cell's inputs on the card from the seed, warms the program
up on them, measures for `--seconds`, checks what the window produced
against the plain reference, and prints the result as the last line of
standard output (one JSON object), each compared number beside its limit
as the last lines of standard error.  It exits non-zero, printing no
result, where the card is missing or a JAX module has been loaded.
"""

import time

T_PROCESS = time.perf_counter()        # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not read"


def main(argv=None) -> int:
    args = parse(argv)
    cells = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
    chips = {w["name"]: w["chips"] for w in cells}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slam_bench: {args.workload} needs {chips} CUDA device(s), "
              f"torch finds {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from slam_bench import harness

    cell = harness.load_cell(ROOT / "BENCHMARK.json", BENCH, args.workload,
                             bool(args.trace), "cuda")
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              T_PROCESS)
    for k, v in result["info"].items():
        print(f"info {k}: {v}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
