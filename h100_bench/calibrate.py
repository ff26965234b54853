"""Readings from which a cell's limits are set, not part of a run.

    python3 h100_bench/calibrate.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...]

For each seed, in one process: a run of the cell as `run.py` makes it, and
beside the program's numbers the control's (the reference in the next
precision below the configuration's: float8 for the bf16 trainer) and the
reference with a planted fault (half of the batch left out). One JSON line
a seed.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))

from benchlib import env  # noqa: E402
import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    env.prepare(BENCH_DIR.parent)
    problem = env.card_problem(1)
    if problem:
        print(f"calibrate: {problem}", file=sys.stderr)
        return 2
    import torch
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        ctx = run.make_context(args.workload, seed, args.seconds, 0, device,
                               time.perf_counter(), calibrate=True)
        out = run.run_cell(ctx)
        print(json.dumps({"seed": seed, "setup_s": out["setup_s"],
                          "e2e": out["e2e"], "checks": out["checks"],
                          "failed": out["failed"],
                          "calibration": out["calibration"]}), flush=True)
        torch.cuda.empty_cache()
    found = env.loaded_forbidden()
    if found:
        print(f"calibrate: loaded {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
