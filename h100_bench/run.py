"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell's files (`workloads/<cell>.json`, its configuration and traffic
mix) say what runs; `traffic/<driver>.py` runs it on the card: set-up
(inputs and weights from the seed, warm-up), the measured window, with
`--trace 1` a traced pass after it, then the comparison with the plain
reference. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1`
`breakdown`, and last `checks`, each number compared beside its limit
(also the last lines of standard error).

Exits non-zero, with no result, when the program is missing, without the
cards the cell asks for, or when JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))

from benchlib import cells, env  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def make_context(name, seed, seconds, trace, device, setup_t0,
                 calibrate=False, mix_overrides=None):
    workload, config, mix = cells.cell_files(name)
    mix = {**mix, **(mix_overrides or {})}
    return cells.Context(name=name, seed=seed % (1 << 63), seconds=seconds,
                         trace=bool(trace), workload=workload, config=config,
                         mix=mix, device=device, setup_t0=setup_t0,
                         calibrate=calibrate)


def run_cell(ctx) -> dict:
    """The driver's outcome of one run of ctx's cell."""
    return cells.driver(ctx.mix).run(ctx)


def metric_values(bench, cell, outcome, trace):
    """{name: {"value", "unit"}} of the cell's metrics: end to end, or with
    `trace` per layer (a reader that finds nothing is left out)."""
    out = {}
    if not trace:
        for m in cells.metrics_of(bench, cell, "end_to_end"):
            v = (outcome["setup_s"] if m["name"] == "setup_s"
                 else outcome["e2e"].get(m["name"]))
            if v is not None and math.isfinite(v):
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out
    for m in cells.metrics_of(bench, cell, "per_layer"):
        v = cells.reader(m["name"]).read(outcome["facts"])
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def judge(checks):
    """(correct, [{"name", "value", "limit"}]): each number at or under
    its limit, and finite."""
    rows = [{"name": n, "value": v, "limit": lim} for n, v, lim in checks]
    ok = all(math.isfinite(r["value"]) and r["value"] <= r["limit"]
             for r in rows)
    return ok and bool(rows), rows


def _json_number(v):
    return v if math.isfinite(v) else str(v)


def main(argv=None) -> int:
    args = parse(argv)
    env.prepare(BENCH_DIR.parent)
    bench = cells.benchmark()
    try:
        entry = cells.entry(bench, args.workload)
    except KeyError as e:
        print(f"h100_bench: {e.args[0]}; no result", file=sys.stderr)
        return 2
    if importlib.util.find_spec("stinet_tpu_torch") is None:
        print("h100_bench: the program (stinet_tpu_torch) is not in the "
              "checkout; no result", file=sys.stderr)
        return 4
    problem = env.card_problem(int(entry["chips"]))
    if problem:
        print(f"h100_bench: {problem}; no result", file=sys.stderr)
        return 2
    import torch
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = make_context(args.workload, args.seed, args.seconds, args.trace,
                       device, T0)
    outcome = run_cell(ctx)
    found = env.loaded_forbidden()
    if found:
        print(f"h100_bench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    correct, rows = judge(outcome["checks"])
    correct = correct and outcome["failed"] == 0
    result = {"correct": correct, "attempted": outcome["attempted"],
              "failed": outcome["failed"],
              "metrics": metric_values(bench, args.workload, outcome,
                                       args.trace),
              "device": env.device_info(int(entry["chips"]),
                                        outcome["memory_peak_bytes"])}
    if args.trace:
        s = outcome["summary"]
        result["device"].update(busy_s=s.busy_s, window_s=s.window_s)
        result["breakdown"] = s.breakdown()
        print(f"trace: {s.launches} launches over {s.items} items; device "
              f"s by range {dict(s.ranges)}; least s by range "
              f"{outcome['facts'].get('bounds')}", file=sys.stderr)
    result["checks"] = [{**r, "value": _json_number(r["value"])}
                        for r in rows]
    for r in rows:
        print(f"check {r['name']}: {r['value']!r} (limit {r['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
