"""Find the knee of an open-loop cell: the highest arrival rate the program
sustains, by one sweep of rates in one process (set up once).

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds <s> \
        --rates 10,20,30,40

For each rate it drives a window of --seconds at that rate (the cell's mix
otherwise unchanged) and prints one JSON line: the requests, the median
and 95th-percentile latency, the median service time (dequeue to result),
the rate completed, and the backlog's growth (the median latency of the
last quarter of requests over that of the first quarter, shown, not
judged: with few requests it swings). A rate is sustained where every
request is answered, the rate completed keeps within 5% of the rate
offered, and the 95th percentile stays within ten median service times;
the knee is the highest sustained rate below the first that is not.
The last line names the knee and four fifths of it, the rate a cell below
the knee is set to (cells/<cell>.json, "rate_per_s"). Answers are not
checked here: run.py checks them.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def summary(requests, window_s: float) -> dict:
    lat = sorted((r.end - r.due_abs) * 1e3 for r in requests)
    order = sorted(requests, key=lambda r: r.due)
    q = max(1, len(order) // 4)
    first = statistics.median((r.end - r.due_abs) for r in order[:q])
    last = statistics.median((r.end - r.due_abs) for r in order[-q:])
    return {"requests": len(requests),
            "failed": sum(1 for r in requests if r.error),
            "p50_ms": lat[len(lat) // 2],
            "p95_ms": lat[max(0, -(-95 * len(lat) // 100) - 1)],
            "service_ms": statistics.median(
                (r.end - r.start) * 1e3 for r in requests),
            "completed_per_s": len(requests) / window_s,
            "backlog_growth": last / first}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    harness.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    if cell.mix["loop"] != "open":
        print(f"{args.workload} is not an open-loop cell", file=sys.stderr)
        return 2
    session = harness.Session(cell, args.seed, "cuda")
    t0 = time.perf_counter()
    session.setup()
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    knee, rows = None, []
    for rate in (float(r) for r in args.rates.split(",")):
        cell.mix["rate_per_s"] = rate
        session.prepare(args.seconds)
        requests, window_s, _ = session.window(args.seconds)
        row = {"rate_per_s": rate, **summary(requests, window_s)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if (row["failed"] or row["completed_per_s"] < 0.95 * rate
                or row["p95_ms"] > 10 * row["service_ms"]):
            break
        knee = rate
    print(json.dumps({"workload": args.workload, "knee_per_s": knee,
                      "four_fifths_per_s": knee and 0.8 * knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
