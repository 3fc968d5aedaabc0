"""Run a cell with the configuration's control in the program's place: the
program's own reduced-precision twin (the configuration's "control",
ServerKey / LWEBSK.with_fast_mode arguments), at the cell's own size and
load, on several seeds in one process, and print the numbers compared with
their limits. The control has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 10
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
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
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run(bench, cell, seed, args.seconds, False, "cuda",
                          time.perf_counter(), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": cell.config["control"],
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
