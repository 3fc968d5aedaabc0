"""The harness end to end on the CPU at tiny sizes: a throwaway cell added
from new files only (configuration, mix, cell values, a metric reader),
run traced and untraced; `correct` false under the configurations'
reduced-precision control and under each fault the cells can have,
planted where the answer is produced."""

import json
import shutil
import time

import numpy as np
import pytest

from conftest import ROOT, TINY_BOOLEAN, TINY_INT4
from portbench import harness

TABLES = {"affine": [(3 * x + 1) % 16 for x in range(16)],
          "square": [(x * x) % 16 for x in range(16)]}


def tiny_root(tmp_path, loop: str):
    """A copy of the benchmark's folder plus new files only: two tiny
    configurations, a mix, cell values and a metric reader, and a
    BENCHMARK.json that names them."""
    pkg = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    (pkg / "configs" / "tiny_bool.json").write_text(json.dumps(
        {"system": "boolean", "parameters": TINY_BOOLEAN,
         "control": {"levels": 1}}))
    (pkg / "configs" / "tiny_int4.json").write_text(json.dumps(
        {"system": "int4_lut", "parameters": TINY_INT4,
         "encoder": {"min": 0.0, "max": 15.0, "precision": 4, "padding": 1},
         "control": {"limb_drop": 2}}))
    mix = {"loop": loop, "check_rows": 3, "schedule_seed": 1,
           "trace_skip_s": 0.0,
           "trace_s": 0.3, "pool": 3, "rate_per_s": 20.0,
           "sizes": ({"kind": "fixed", "rows": 8} if loop == "closed"
                     else {"kind": "log_uniform", "low": 1, "high": 8})}
    (pkg / "traffic" / "tiny_mix.json").write_text(json.dumps(mix))
    (pkg / "cells" / "tiny_bool.tiny_mix.json").write_text(json.dumps(
        {"ops": ["and", "xor", "mux"], "tiers": [4, 8]}))
    (pkg / "cells" / "tiny_int4.tiny_mix.json").write_text(json.dumps(
        {"ops": ["affine", "square"], "functions": TABLES}))
    (pkg / "metrics" / "tiny.requests_traced.py").write_text(
        "def read(ctx):\n"
        "    return len(ctx.trace.spans) if ctx.trace else None\n")
    for c in ("tiny_bool", "tiny_int4"):
        bench["configs"].append({"name": c, "source": "test", "reduced": [],
                                 "file": f"portbench/configs/{c}.json",
                                 "why": "test"})
        bench["workloads"].append({"name": f"{c}.tiny_mix", "config": c,
                                   "traffic": "tiny_mix", "chips": 1,
                                   "why": "test"})
    bench["end_to_end"].append({"name": "gates_per_s.tiny", "unit": "rows/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock"})
    shutil.copy(pkg / "metrics" / "gates_per_s.py",
                pkg / "metrics" / "gates_per_s.tiny.py")
    bench["per_layer"].append({"name": "tiny.requests_traced", "unit": "1",
                               "better": "higher", "source": "program_span",
                               "layer": "test", "moves": "gates_per_s.tiny"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path, bench


def run(root, bench, cell, trace=False, **kw):
    return harness.run(bench, harness.find_cell(bench, cell, root), 7, 0.6,
                       trace, "cpu", time.perf_counter(), log=lambda *a: None,
                       **kw)


@pytest.mark.parametrize("config", ["tiny_bool", "tiny_int4"])
@pytest.mark.parametrize("loop", ["closed", "open"])
def test_throwaway_cell_from_new_files(tmp_path, config, loop):
    root, bench = tiny_root(tmp_path, loop)
    out = run(root, bench, f"{config}.tiny_mix")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert set(out["metrics"]) == {"gates_per_s.tiny", "setup_s"}
    assert out["metrics"]["gates_per_s.tiny"]["value"] > 0
    assert list(out)[-1] == "checks"
    traced = run(root, bench, f"{config}.tiny_mix", trace=True)
    assert traced["correct"]
    assert traced["metrics"]["tiny.requests_traced"]["value"] >= 1
    assert "busy_s" in traced["device"] and "breakdown" in traced


@pytest.mark.parametrize("config", ["tiny_bool", "tiny_int4"])
def test_control_is_not_correct(tmp_path, config):
    root, bench = tiny_root(tmp_path, "closed")
    out = run(root, bench, f"{config}.tiny_mix", control=True)
    assert not out["correct"]
    first = next(iter(out["checks"].values()))
    assert first["value"] > 0


def _altered(out):
    """One word of every answer changed where it is produced."""
    if isinstance(out, tuple):
        return tuple(_altered(o) for o in out)
    out = out.copy()
    out[:, -1] += 1
    return out


def _half_batch(out):
    """Only the first half of the batch computed, repeated for the rest."""
    if isinstance(out, tuple):
        return tuple(_half_batch(o) for o in out)
    out = out.copy()
    half = (len(out) + 1) // 2
    out[half:] = out[:len(out) - half]
    return out


@pytest.mark.parametrize("fault", ["altered", "half_batch", "stale"])
@pytest.mark.parametrize("config", ["tiny_bool", "tiny_int4"])
def test_faults_are_not_correct(tmp_path, monkeypatch, config, fault):
    root, bench = tiny_root(tmp_path, "closed")
    real = harness.load_system

    def broken_system(kind):
        base = real(kind)

        class Broken(base):
            last = None

            def call(self, request):
                out = base.call(self, request)
                if fault == "altered":
                    return _altered(out)
                if fault == "half_batch":
                    return _half_batch(out)
                stale, Broken.last = Broken.last, out   # state unchanged
                return out if stale is None else stale

        return Broken

    monkeypatch.setattr(harness, "load_system", broken_system)
    out = run(root, bench, f"{config}.tiny_mix")
    assert not out["correct"], out["checks"]


def test_same_seed_same_inputs(tmp_path):
    root, bench = tiny_root(tmp_path, "open")
    cells = [harness.find_cell(bench, "tiny_bool.tiny_mix", root)
             for _ in range(2)]
    got = []
    for cell in cells:
        session = harness.Session(cell, 99, "cpu")
        session.system.keys = __import__(
            "portbench.plain.boolean", fromlist=["x"]).make_keys(
                session.system.gen, session.system.p, "cpu")
        session.prepare(1.0)
        got.append([(r.op, r.rows, r.due, r.inputs[0][0].tobytes())
                    for r in session.plan])
    assert got[0] == got[1]
    assert np.isclose(got[0][-1][2], 1.0, atol=0.5)


def test_sweep_summary_at_two_rates(tmp_path):
    from portbench import sweep

    root, bench = tiny_root(tmp_path, "open")
    cell = harness.find_cell(bench, "tiny_bool.tiny_mix", root)
    session = harness.Session(cell, 5, "cpu")
    session.setup()
    for rate in (5.0, 10.0):
        cell.mix["rate_per_s"] = rate
        session.prepare(0.5)
        requests, window_s, _ = session.window(0.5)
        row = sweep.summary(requests, window_s)
        assert row["requests"] == round(rate * 0.5) and row["failed"] == 0
        assert row["p95_ms"] >= row["p50_ms"] > 0
