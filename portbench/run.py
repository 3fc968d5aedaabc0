"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Cells are the "workloads" of BENCHMARK.json at the root of the checkout.
The run makes the keys and the traffic from the seed, sets the program
(concrete_tpu_torch) up and warms every shape the traffic uses, measures
for --seconds, checks the answers against the plain reference and prints,
as its last line, one JSON object: correct, attempted, failed, metrics
(--trace 0: the cell's end-to-end metrics; --trace 1: its per-layer
metrics, read from a torch.profiler trace of a stretch of the window),
device, with --trace 1 breakdown, and last the numbers compared with
their limits, which also end standard error.

It exits with a code other than 0 and prints no result where there is no
CUDA card, fewer cards than the cell asks for, no program beside it, or
where jax, jaxlib, flax or concrete_tpu has been loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    harness.cache_env()
    import torch

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find_cell(bench, args.workload)
    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run(bench, cell, args.seed, args.seconds,
                         bool(args.trace), "cuda", T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules that must not load were loaded: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
