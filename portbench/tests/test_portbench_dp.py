"""The data-parallel cell's pieces on the CPU: a throwaway "boolean_dp" cell
at a tiny configuration, its front over two gloo CPU ranks, runs to a
correct result (traced too, where the front's spans reach
dp.exchange_ms.dp4) and its control does not; the readers of the dp4 cell
give their values on a synthetic trace and counts and None where what they
read is absent, as on a program without the front; card 0's roofline share
counts a card's share of the rows."""

import json
import time
import types

import pytest

from conftest import ROOT, TINY_BOOLEAN
from portbench import harness, tracing, traffic
from test_portbench_harness import tiny_root

CELL = "tiny_dp.tiny_mix"
READERS = ["dp.exchange_ms.dp4", "dp.collective_ms.dp4",
           "device.idle_share.dp4", "gate.roofline_share.dp4"]


def dp_root(tmp_path):
    root, bench = tiny_root(tmp_path, "closed")
    pkg = root / "portbench"
    (pkg / "configs" / "tiny_dp.json").write_text(json.dumps(
        {"system": "boolean_dp", "parameters": TINY_BOOLEAN, "dp": 2,
         "control": {"levels": 1}}))
    (pkg / "cells" / f"{CELL}.json").write_text(json.dumps(
        {"ops": ["and"], "tiers": [4]}))
    bench["configs"].append({"name": "tiny_dp", "source": "test",
                             "reduced": [], "why": "test",
                             "file": "portbench/configs/tiny_dp.json"})
    bench["workloads"].append({"name": CELL, "config": "tiny_dp",
                               "traffic": "tiny_mix", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bench


def run(root, bench, trace=False, **kw):
    return harness.run(bench, harness.find_cell(bench, CELL, root), 7, 0.6,
                       trace, "cpu", time.perf_counter(), log=lambda *a: None,
                       **kw)


def test_dp_cell_is_correct_and_its_control_is_not(tmp_path):
    root, bench = dp_root(tmp_path)
    out = run(root, bench)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert out["checks"]["rows_checked"]["value"] >= 1
    traced = run(root, bench, trace=True)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["dp.exchange_ms.dp4"]["value"] > 0
    assert "dp.collective_ms.dp4" not in traced["metrics"]   # no NCCL here
    control = run(root, bench, control=True)
    assert not control["correct"]
    assert control["checks"]["mismatched_words"]["value"] > 0


def ctx_with(trace, requests=()):
    return harness.Context(params={}, system=None, requests=list(requests),
                           window_s=1.0, setup_s=1.0, trace=trace)


def read(name, ctx):
    return harness.load_reader(name, ROOT / "portbench")(ctx)


def synthetic_trace(counts, device_ops):
    return tracing.Trace(
        window_s=2.0, busy_s=1.5,
        spans={0: (0.0, 1e6, 0.9e6), 1: (1e6, 2e6, 0.6e6)},
        device_ops=device_ops, idle_gaps=[], counts=counts)


REQUESTS = [traffic.Request(i, "and", 8192, error=None) for i in range(2)]
COUNTS = {"span_ns": {"dp.send": 18_000_000, "dp.gather": 6_000_000,
                      "graph.replay": 1_000_000},
          "span_calls": {"dp.send": 2, "dp.gather": 2, "dp.and": 2}}
OPS = [["ntt_cmux_kernel", 1.2], ["Memcpy HtoD (Pageable -> Device)", 0.02],
       ["ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage)", 0.001],
       ["ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage)", 0.003]]


@pytest.mark.parametrize("name,want", [
    ("dp.exchange_ms.dp4", 12.0),       # (18 + 6) ms over 2 calls
    ("dp.collective_ms.dp4", 2.0),      # 4 ms of NCCL over 2 calls
    ("device.idle_share.dp4", 25.0),    # 1.5 s busy of 2
])
def test_reader_gives_its_value(name, want):
    ctx = ctx_with(synthetic_trace(COUNTS, OPS), REQUESTS)
    assert read(name, ctx) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_what_it_reads_gives_none(name):
    assert read(name, ctx_with(None, REQUESTS)) is None
    if name in ("dp.exchange_ms.dp4", "dp.collective_ms.dp4"):
        # a one-card program: no dp span, no NCCL kernel
        single = synthetic_trace({"span_ns": {"gate.and": 5},
                                  "span_calls": {"gate.and": 1}}, OPS[:2])
        assert read(name, ctx_with(single, REQUESTS)) is None


def test_card_roofline_share_counts_a_card_of_the_rows():
    """dp4's share at 8192 rows over four cards is the one-card reader's at
    2048 rows on the same busy time; 8193 rows give card 0 2049."""
    params = json.loads((ROOT / "portbench" / "configs"
                         / "boolean_default_dp4.json").read_text())
    p = dict(params["parameters"], bits=32)
    system = types.SimpleNamespace(config={"dp": 4},
                                   pbs_rows=lambda op, rows: rows,
                                   operands=lambda op: 2)
    tr = synthetic_trace({}, OPS)

    def share(name, rows):
        reqs = [traffic.Request(i, "and", rows, error=None) for i in range(2)]
        return read(name, harness.Context(p, system, reqs, 1.0, 1.0, tr))

    card = share("gate.roofline_share.dp4", 8192)
    assert card == pytest.approx(share("gate.roofline_share.gates", 2048))
    assert 0 < card < 100
    assert share("gate.roofline_share.dp4", 8193) == pytest.approx(
        share("gate.roofline_share.gates", 2049))
