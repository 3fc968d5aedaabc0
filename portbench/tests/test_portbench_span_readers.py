"""The readers of the program's spans and counters (gate_rows, span_ns,
span_calls, capture_ns): each gives its value on a synthetic context that
holds its counter and None where the counter is absent, as on a program
without it; and, on the CPU at tiny sizes, the gate and high-level readers
report from a traced run of a throwaway cell."""

import time

import pytest

from conftest import ROOT
from portbench import harness, tracing
from test_portbench_harness import tiny_root

MS = 1_000_000  # ns


def ctx_with(counts: dict | None) -> harness.Context:
    trace = None if counts is None else tracing.Trace(
        window_s=1.0, busy_s=0.5, spans={}, device_ops=[], idle_gaps=[],
        counts=counts)
    return harness.Context(params={}, system=None, requests=[], window_s=1.0,
                           setup_s=1.0, trace=trace)


def read(name: str, ctx):
    return harness.load_reader(name, ROOT / "portbench")(ctx)


SPANS = {"span_ns": {"graph.replay": 30 * MS, "highlevel.slots": 90 * MS,
                     "gate.pad": 5 * MS},
         "span_calls": {"graph.replay": 12, "highlevel.slots": 6,
                        "highlevel.bootstrap": 3, "gate.pad": 12}}

CASES = [
    ("batching.request_row_share.latency",
     {"gate_rows": {"request": 51, "padding": 49}}, 51.0),
    ("dispatch.launch_ms.latency", SPANS, 2.5),
    ("dispatch.launch_ms.lut_latency", SPANS, 2.5),
    ("highlevel.slots_ms.pbs", SPANS, 30.0),
]


@pytest.mark.parametrize("name,counts,want", CASES)
def test_reader_of_a_counter_gives_its_value(name, counts, want):
    assert read(name, ctx_with(counts)) == pytest.approx(want)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_reader_without_its_counter_gives_none(name):
    for counts in (None, {}, {"launches": {"B=256 N=512": 4}}):
        assert read(name, ctx_with(counts)) is None


def test_capture_seconds_read_from_the_registered_counts(monkeypatch):
    counts = {"capture_ns": {"and (ntt)": 1_500_000_000,
                             "mux (ntt)": 500_000_000},
              "span_ns": {"graph.capture": 7}}
    monkeypatch.setattr(harness, "counts_snapshot", lambda: counts)
    assert read("setup.capture_s", ctx_with(None)) == pytest.approx(2.0)
    monkeypatch.setattr(harness, "counts_snapshot",
                        lambda: {"sent_bytes": {"all_reduce": 8}})
    assert read("setup.capture_s", ctx_with({})) is None


@pytest.mark.parametrize("config,names", [
    ("tiny_bool", ["batching.request_row_share.latency"]),
    ("tiny_int4", ["highlevel.slots_ms.pbs"]),
])
def test_readers_report_from_a_traced_tiny_run(tmp_path, config, names):
    root, bench = tiny_root(tmp_path, "open")
    cell = f"{config}.tiny_mix"
    for m in bench["per_layer"]:
        if m["name"] in names:
            m["workloads"] = [cell]
    out = harness.run(bench, harness.find_cell(bench, cell, root), 7, 0.6,
                      True, "cpu", time.perf_counter(), log=lambda *a: None)
    assert out["correct"], out["checks"]
    for name in names:
        value = out["metrics"][name]["value"]
        assert 0 < value <= (100 if out["metrics"][name]["unit"] == "%"
                             else 1e4), (name, value)
