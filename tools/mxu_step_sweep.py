#!/usr/bin/env python3
"""Time one u64 CMux step both ways on one GPU and find the batch where the
window step stops paying: the table step (K1 build_tables, torch._int_mm
on gemm_rows rows, recombine_acc) against window_step (one kernel, no
table in device memory).

    python3 tools/mxu_step_sweep.py [--out DIR] [--batches 1,16,...]

At the int4 widths (N = 1024, k = 1, PBS bl 7 l 3, u64) with limb_drop 0
and 2, and B = 1, 16, 32, 64, 128, 256, 512 and 2048: each step form is
captured 20 times into a CUDA graph (a new ring of keys each step, as a
rotation reads them) and replayed between CUDA events after a warm-up
replay; window_step also at each rows-a-block it takes (16, 32).
Both forms start from the same accumulator and are checked equal, bit for
bit, before any timing. One JSON line per timing, then one summary line
per (limb_drop, B): both forms' µs a step at the wrapper's rows, the
window step's bound (the larger of its int8 operations at 1,979 TOP/s and
its bytes, d8, the rings and acc read and written, at 3.35 TB/s) and its
share of it; the last line gives the crossover, the largest B at which
the window step is faster at both limb_drops. With --out, the lines also
go to DIR/mxu_step_sweep.jsonl.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from concrete_tpu_torch.core import bootstrap as bs  # noqa: E402
from concrete_tpu_torch.core import bootstrap_mxu as bsx  # noqa: E402
from concrete_tpu_torch.ops import _cuda  # noqa: E402

BATCHES = (1, 16, 32, 64, 128, 256, 512, 2048)
STEPS = 20          # steps a graph
INT8_OPS_S = 1979e12
HBM_BYTES_S = 3.35e12


def int4_plan(drop: int) -> bsx.MxuPlan:
    return bsx.MxuPlan.from_config(bs.ServerConfig(
        lwe_dimension=STEPS, glwe_dimension=1, polynomial_size=1024,
        pbs_base_log=7, pbs_level=3, ks_base_log=2, ks_level=8, bits=64,
        mxu_limb_drop=drop))


def window_bound_us(plan: bsx.MxuPlan, b: int) -> float:
    n, r, ks1 = plan.polynomial_size, plan.row_blocks, plan.glwe_size
    ops = 2 * b * r * n * ks1 * plan.limbs_used * n
    bytes_ = b * r * n + r * ks1 * 2 * 2 * n * 4 + 2 * ks1 * b * n * 8
    return max(ops / INT8_OPS_S, bytes_ / HBM_BYTES_S) * 1e6


def graph_us(step, reps: int = 3) -> float:
    """µs a step of STEPS calls of step(i) captured in one CUDA graph, the
    least of `reps` timed replays after a warm-up replay."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for i in range(STEPS):          # warm-up: builds, attributes
            step(i)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(STEPS):
            step(i)
    graph.replay()
    best = float("inf")
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) * 1e3 / STEPS)
    return best


def sweep(drop: int, b: int, dev, emit) -> dict:
    plan = int4_plan(drop)
    n, r, ks1 = plan.polynomial_size, plan.row_blocks, plan.glwe_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(b * 31 + drop)
    rings = torch.randint(-(2 ** 31), 2 ** 31, (STEPS, r, ks1 * 2, 2 * n),
                          generator=gen, device=dev, dtype=torch.int64
                          ).to(torch.int32)
    acc0 = torch.randint(-(2 ** 62), 2 ** 62, (ks1, b, n), generator=gen,
                         device=dev, dtype=torch.int64)
    d8 = torch.randint(-64, 65, (b, r * n), generator=gen, device=dev,
                       dtype=torch.int64).to(torch.int8)
    dp, rhs, s = bsx._step_buffers(plan, b, dev)
    dp[:b] = d8
    acc_t, acc_w = acc0.clone(), acc0.clone()

    def table_step(i):
        bsx.build_tables(rings[i], n, drop, 2, out=rhs)
        bsx.recombine_acc(plan, bsx.step_dot(dp, rhs, s, rows=b), acc_t,
                          out=acc_t)

    def window_step(i, rows=None):
        if rows is None:
            bsx.window_step(plan, acc_w, d8, rings[i], out=acc_w)
        else:
            _cuda.launch("ctt_window_step", d8, rings[i], acc_w, b, ks1, n, r,
                         plan.limbs_used, drop, rows)

    for i in range(2):
        table_step(i)
        window_step(i)
    torch.cuda.synchronize()
    if not torch.equal(acc_t, acc_w):
        raise AssertionError(f"limb_drop={drop} B={b}: window_step differs "
                             "from the table step")
    row = {"limb_drop": drop, "B": b, "table_us": graph_us(table_step),
           "window_us": graph_us(window_step),
           "window_rows": bsx.window_rows(b),
           "bound_us": window_bound_us(plan, b)}
    for rows in (16, 32):
        us = graph_us(lambda i, rows=rows: window_step(i, rows))
        emit({"limb_drop": drop, "B": b, "rows": rows, "window_us": us})
        row[f"window_us_rows{rows}"] = us
    row["window_share"] = row["bound_us"] / row["window_us"]
    emit(row)
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path)
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    _cuda.load_all()
    lines = []

    def emit(rec):
        print(json.dumps(rec), flush=True)
        lines.append(rec)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    faster = {}
    for drop in (0, 2):
        for b in map(int, args.batches.split(",")):
            row = sweep(drop, b, dev, emit)
            faster.setdefault(b, []).append(row["window_us"] < row["table_us"])
    wins = [b for b in sorted(faster) if all(faster[b])]
    crossover = max((b for b in wins if all(all(faster[c]) for c in faster
                                            if c <= b)), default=0)
    emit({"crossover_B": crossover, "WINDOW_MAX_BATCH": bsx.WINDOW_MAX_BATCH})
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        with open(args.out / "mxu_step_sweep.jsonl", "w") as f:
            f.writelines(json.dumps(rec) + "\n" for rec in lines)


if __name__ == "__main__":
    main()
