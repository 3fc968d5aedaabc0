"""The port's spans and counters (ops/graphs.span, SPAN_NS, SPAN_CALLS,
CAPTURE_NS, boolean.server_key.GATE_ROWS): a span records nothing without
a torch.profiler session or inside a capture, and under a session lands in
the exported trace, nested in the span around it, and in its counters; the
gate API counts request and padding rows and names its steps; the
high-level bootstrap and keyswitch name theirs; no plain counter has a key
that reads as a kernel's batch shape ("B=<n>").

The last test is marked `cuda` (it needs an NVIDIA GPU and nvcc, and skips
anywhere else; the check runs inside a fixture, never at import). On a GPU
machine (where JAX, which tests/conftest.py imports, may be absent):
    python -m pytest --noconftest tests/test_torch_spans.py"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from concrete_tpu_torch import boolean
from concrete_tpu_torch.boolean import server_key
from concrete_tpu_torch.core import bootstrap_mxu
from concrete_tpu_torch.dispersion import StandardDev
from concrete_tpu_torch.highlevel import (
    LWEBSK,
    LWEKSK,
    Encoder,
    LWEParams,
    LWESecretKey,
    RLWEParams,
    RLWESecretKey,
    VectorLWE,
)
from concrete_tpu_torch.ops import _cuda, graphs
from concrete_tpu_torch.params import BooleanParameters

# a kernel's batch shape key, as the benchmark's row counts read it
SHAPE_KEY = re.compile(r"(?:^| )B=(\d+)")


def _spans() -> tuple[dict, dict]:
    return dict(graphs.SPAN_NS.by_key), dict(graphs.SPAN_CALLS.by_key)


def _moved(before: dict, after: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def _annotations(prof, tmp_path) -> list[tuple[str, float, float]]:
    """(name, start, end) of every user annotation in the exported trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(spans, inner: str, outer: str) -> bool:
    """Every `inner` span lies within some `outer` span."""
    outs = [(s, e) for n, s, e in spans if n == outer]
    ins = [(s, e) for n, s, e in spans if n == inner]
    return bool(ins) and all(any(s0 <= s and e <= e0 for s0, e0 in outs)
                             for s, e in ins)


def test_a_span_without_a_profiler_records_nothing():
    ns, calls = _spans()
    assert not torch.autograd._profiler_enabled()
    with graphs.span("test.off") as got:
        torch.ones(4).sum()
    assert got is None
    assert graphs.span("test.off") is graphs.span("test.other")
    assert _spans() == (ns, calls)


def test_a_span_under_the_profiler_lands_in_the_trace_and_its_counts(
        tmp_path):
    ns, calls = _spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.outer"):
            for _ in range(2):
                with graphs.span("test.on"):
                    torch.ones(8).sum()
    ns1, calls1 = _spans()
    assert _moved(calls, calls1) == {"test.on": 2}
    assert set(_moved(ns, ns1)) == {"test.on"} and ns1["test.on"] > ns.get(
        "test.on", 0)
    spans = _annotations(prof, tmp_path)
    assert sum(n == "test.on" for n, _, _ in spans) == 2
    assert _inside(spans, "test.on", "test.outer")


def test_a_span_inside_a_capture_records_nothing(monkeypatch, tmp_path):
    ns, calls = _spans()
    monkeypatch.setattr(graphs, "_capturing", True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with graphs.span("test.captured"):
            torch.ones(8).sum()
    assert _spans() == (ns, calls)
    assert "test.captured" not in {n for n, _, _ in _annotations(prof,
                                                                tmp_path)}


@pytest.fixture(scope="module")
def gate_keys():
    tiny = BooleanParameters(4, 1, 64, StandardDev(2.0 ** -20),
                             StandardDev(2.0 ** -25), 7, 3, 2, 5)
    cks, sks = boolean.gen_keys(tiny, secret_seed=1, mask_seed=2,
                                noise_seed=3, device="cpu")
    sks.warmup(batch_sizes=(8,), gates=("and",), mux=True)
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (3, 5)).astype(bool)
    cts = [cks.encrypt(b, mask_seed=5 + i, noise_seed=9 + i)
           for i, b in enumerate(bits)]
    return cks, sks, bits, cts


@pytest.mark.parametrize("gate", ["and", "mux"])
def test_gate_rows_and_gate_spans(gate_keys, gate, tmp_path):
    """A 5-row call on a key warmed at tier 8: 5 request rows, 3 padding
    rows (a MUX row counts once), and the gate's span holding pad and
    cut."""
    cks, sks, bits, cts = gate_keys
    rows = dict(server_key.GATE_ROWS.by_key)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if gate == "and":
            out, want = sks.and_(*cts[:2]), bits[0] & bits[1]
        else:
            out, want = sks.mux(*cts), np.where(bits[0], bits[1], bits[2])
    np.testing.assert_array_equal(cks.decrypt(out), want)
    assert _moved(rows, server_key.GATE_ROWS.by_key) == {"request": 5,
                                                         "padding": 3}
    spans = _annotations(prof, tmp_path)
    assert _inside(spans, "gate.pad", f"gate.{gate}")
    assert _inside(spans, "gate.cut", f"gate.{gate}")


@pytest.fixture(scope="module")
def highlevel_keys():
    sk = LWESecretKey.new(LWEParams(16, -40), secret_seed=1)
    rsk = RLWESecretKey.new(RLWEParams(256, 1, -50), secret_seed=2)
    bsk = LWEBSK.new(sk, rsk, 7, 3, mask_seed=3, noise_seed=4, device="cpu")
    ksk = LWEKSK.new(rsk.to_lwe_secret_key(), sk, 2, 8, mask_seed=5,
                     noise_seed=6, device="cpu")
    enc = Encoder.new(0.0, 8.0, nb_bit_precision=3, nb_bit_padding=1)
    v = VectorLWE.encode_encrypt(sk, [1.0, 2.0, 5.0], enc, mask_seed=7,
                                 noise_seed=8)
    return sk, bsk, ksk, enc, v


def test_bootstrap_all_with_function_names_its_host_steps(highlevel_keys,
                                                          tmp_path):
    _, bsk, _, enc, v = highlevel_keys
    ns, calls = _spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = v.bootstrap_all_with_function(bsk, lambda x: x, enc)
    assert out.nb_ciphertexts == 3
    spans = _annotations(prof, tmp_path)
    for step in ("highlevel.lut", "highlevel.slots", "highlevel.to_device",
                 "highlevel.to_host"):
        assert _inside(spans, step, "highlevel.bootstrap"), step
    assert _moved(calls, _spans()[1]) == {
        "highlevel.bootstrap": 1, "highlevel.lut": 1, "highlevel.slots": 1,
        "highlevel.to_device": 1, "highlevel.to_host": 1}


def test_keyswitch_names_its_host_steps(highlevel_keys, tmp_path):
    _, bsk, ksk, enc, v = highlevel_keys
    big = v.bootstrap_all_with_function(bsk, lambda x: x, enc)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = big.keyswitch(ksk)
    assert out.data.shape == (3, 17)
    spans = _annotations(prof, tmp_path)
    for step in ("highlevel.to_device", "highlevel.to_host",
                 "highlevel.slots"):
        assert _inside(spans, step, "highlevel.keyswitch"), step


def test_no_plain_counter_key_reads_as_a_batch_shape(gate_keys,
                                                     highlevel_keys):
    """Only the kernel wrappers key counts by shape ("B=<n> ..."): a plain
    Counter's key that did would change the benchmark's rotated-row count.
    The GraphedCall names are the keys of capture_ns."""
    _, sks, _, cts = gate_keys
    _, bsk, _, enc, v = highlevel_keys
    with profile(activities=[ProfilerActivity.CPU]):
        sks.and_(*cts[:2])
        v.bootstrap_all_with_function(bsk, lambda x: x, enc)
    plain = [c for c in _cuda.COUNTED if isinstance(c, graphs.Counter)]
    assert {graphs.SPAN_NS, graphs.SPAN_CALLS, graphs.CAPTURE_NS,
            server_key.GATE_ROWS, bootstrap_mxu.PAD_BYTES} <= set(plain)
    keys = [k for c in plain for k in c.by_key]
    keys += [g.name for k in (sks, bsk) for g in k.evaluation.graphs.values()]
    assert keys and not [k for k in keys if SHAPE_KEY.search(k)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        pytest.skip("needs nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_capture_records_no_span_and_a_replay_adds_none(dev):
    """Under a profiler session, a function that opens a span is captured:
    its span records in the eager warm run and is off inside the capture,
    so the graph's count record holds no span count; each replay adds only
    the replay's own three spans, and capture_ns keeps the capture under
    the call's name."""

    def fn(key, x):
        with graphs.span("test.inside_capture"):
            return key * x

    call = graphs.GraphedCall(fn, 1, name="test spans")
    key = torch.arange(4, device=dev)
    x = torch.ones(4, dtype=torch.int64, device=dev)
    captured = graphs.CAPTURE_NS.by_key.get("test spans", 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        assert torch.equal(call(key, x), key)
        (graph,) = call.graphs.values()
        assert graphs.SPAN_NS not in graph.counts
        assert graphs.SPAN_CALLS not in graph.counts
        ns, calls = _spans()
        for _ in range(3):
            assert torch.equal(call(key, 2 * x), 2 * key)
        torch.cuda.synchronize(dev)
        ns1, calls1 = _spans()
    assert graphs.CAPTURE_NS.by_key["test spans"] > captured
    assert _moved(calls, calls1) == {"graph.copy_in": 3, "graph.replay": 3,
                                     "graph.clone_out": 3}
    assert set(_moved(ns, ns1)) == set(_moved(calls, calls1))
    assert calls1["test.inside_capture"] == calls.get(
        "test.inside_capture") == 1
