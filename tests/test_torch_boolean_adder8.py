"""The 8-bit ripple-carry adder (BASELINE.json config 5) through the port's
ServerKey gates on the CPU, against the benchmark's plain adder
(portbench/plain/adder.py): every sum and carry word equal and the sums
equal to a + b, at DEFAULT_PARAMETERS' k=2, N=512, PBS bl 8 l 2 and KS bl
2 l 5 with only the LWE dimension cut (586 to 8), 3 integers. Also: the
spans of an add's gate calls, the configuration boolean_default_adder8 is
the preset field by field, the work gate.roofline_share.gates reads for an
add, circuit.host_ms.adder8's reading of its spans, the cell's check
failing on one flipped word, and, on the card, no host synchronisation
between an add's gate calls."""

import dataclasses

import pytest
import torch

from concrete_tpu_torch.boolean import ServerKey, circuits
from concrete_tpu_torch.dispersion import StandardDev
from concrete_tpu_torch.params import DEFAULT_PARAMETERS, BooleanParameters
from concrete_tpu_torch.torus import to_numpy
from concrete_tpu_torch.ops import graphs
from portbench import harness, tracing, traffic, yardstick
from portbench.plain import adder as plain_adder
from portbench.plain import boolean as plain
from portbench.systems import boolean_adder

PKG = harness.ROOT / "portbench"
CONFIG = PKG / "configs" / "boolean_default_adder8.json"
CUT = dataclasses.replace(DEFAULT_PARAMETERS, lwe_dimension=8)
BITS, COUNT = 8, 3


def _plain_params(params: BooleanParameters) -> dict:
    """The parameters as the benchmark's configuration files give them."""
    out = {}
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        out[f.name] = v.std_dev if isinstance(v, StandardDev) else v
    return out


def _keys(params: BooleanParameters, seed: int, device="cpu"):
    """The plain reference's keys from a seed, and the ServerKey of their
    standard forms (backend "auto")."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p = dict(_plain_params(params), bits=32)
    ref = plain.make_keys(gen, p, device)
    sks = ServerKey.from_arrays(to_numpy(ref["bsk"].to(torch.int32)),
                                to_numpy(ref["ksk"].to(torch.int32)),
                                params, device=device)
    return gen, p, ref, sks


@pytest.fixture(scope="module")
def added():
    """One 8-bit add of 3 pairs through the port, the plain adder's words,
    the integers and the spans the add recorded under a profiler."""
    gen, p, ref, sks = _keys(CUT, 25)
    a, b = (torch.randint(0, 1 << BITS, (COUNT,), generator=gen)
            for _ in range(2))
    a_ct, b_ct = (plain_adder.encrypt(gen, ref, p, v, BITS) for v in (a, b))
    before = dict(graphs.SPAN_CALLS.by_key)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        sums, carry = circuits.ripple_carry_adder(
            sks, to_numpy(a_ct.to(torch.int32)),
            to_numpy(b_ct.to(torch.int32)))
    counted = {k: n - before.get(k, 0)
               for k, n in graphs.SPAN_CALLS.by_key.items()
               if n != before.get(k, 0)}
    got = torch.cat([sums, carry[None]]).to(torch.int64) & 0xFFFFFFFF
    want_sums, want_carry = plain_adder.add(ref, p, a_ct, b_ct)
    return {"sks": sks, "ref": ref, "a": a, "b": b, "got": got,
            "want": torch.cat([want_sums, want_carry[None]]),
            "counted": counted}


def test_adder_matches_the_plain_reference(added):
    assert added["sks"].resolved_backend() == "ntt"
    got, ref, a, b = added["got"], added["ref"], added["a"], added["b"]
    assert got.shape == (BITS + 1, COUNT, CUT.lwe_dimension + 1)
    assert torch.equal(got, added["want"])
    assert torch.equal(plain_adder.decrypt(ref, got[:-1]), (a + b) % 256)
    assert torch.equal(plain.decrypt(ref, got[-1]), a + b >= 256)


def test_adder_spans_its_gate_calls(added):
    """One span circuit.adder an add, and inside it the gates' own spans:
    XOR 15, AND 1, MUX 7."""
    spans = {k: added["counted"].get(k) for k in
             ("circuit.adder", "gate.xor", "gate.and", "gate.mux")}
    assert spans == {"circuit.adder": 1, "gate.xor": 15, "gate.and": 1,
                     "gate.mux": 7}
    assert sum(spans.values()) - 1 == plain_adder.gate_rows(BITS)


def test_config_is_the_preset():
    conf = harness.load_json(CONFIG)
    assert conf["parameters"] == _plain_params(DEFAULT_PARAMETERS)
    assert conf["system"] == "boolean_adder"
    assert conf["reduced"] == ["chips"] and conf["chips"] == 1
    assert conf["control"] == {"levels": 1}
    mix = harness.load_json(PKG / "traffic" / "adder8.json")
    assert mix["sizes"]["rows"] == 2048 * plain_adder.gate_rows(mix["bits"])


def _ctx(system, requests, counts, busy_us=0.0) -> harness.Context:
    """A reader's context: each request's span 0 to 2 s with `busy_us` of
    device time, and the program's counts of the profiled stretch."""
    trace = tracing.Trace(window_s=2.0, busy_s=busy_us / 1e6,
                          spans={r.id: (0.0, 2e6, busy_us) for r in requests},
                          device_ops=[], idle_gaps=[], counts=counts)
    return harness.Context(params=system.p if system else {}, system=system,
                           requests=requests, window_s=2.0, setup_s=1.0,
                           trace=trace)


def test_roofline_reader_work_of_an_add():
    """gate.roofline_share.gates reads an add of 2048 pairs as one request
    of 47,104 gate rows and 61,440 rotated rows. K9's integer work bounds
    it, so its least time is the 23 gate calls' own: 16 two-operand calls
    at B=2048 and 7 MUX calls rotating 4096 rows, 30 rotations of 586
    steps of 36.5 us."""
    conf = harness.load_json(CONFIG)
    mix = harness.load_json(PKG / "traffic" / "adder8.json")
    system = boolean_adder.System(conf, mix, "cpu", 2 ** 33)
    req = traffic.closed_request(mix, 2 ** 33, 0)
    p, m = system.p, 2048
    calls = (16 * yardstick.ntt_gate_work(p, m, m, 2).bound_seconds()
             + 7 * yardstick.ntt_gate_work(p, m, 2 * m, 3).bound_seconds())
    assert calls == pytest.approx((16 + 14) * 586 * 36.5e-6, rel=0.005)
    busy_us = 2 * calls * 1e6
    share = harness.load_reader("gate.roofline_share.gates", PKG)(
        _ctx(system, [req], {}, busy_us))
    assert share == pytest.approx(50.0, rel=1e-9)


HOST_COUNTS = {"span_ns": {"circuit.adder": 3 * 460_000_000,
                           "graph.replay": 3 * 23 * 18_600_000,
                           "gate.xor": 1},
               "span_calls": {"circuit.adder": 3, "graph.replay": 69}}


@pytest.mark.parametrize("counts,want", [
    (HOST_COUNTS, 460.0 - 23 * 18.6),
    ({"span_ns": {"circuit.adder": 30_000_000},
      "span_calls": {"circuit.adder": 2}}, 15.0),
    ({"span_ns": {"graph.replay": 5}, "span_calls": {"graph.replay": 1}},
     None),
    ({}, None),
], ids=["with-launches", "no-launches", "no-adder", "empty"])
def test_circuit_host_ms_reads_the_adder_less_its_launches(counts, want):
    """circuit.host_ms.adder8: circuit.adder's ns less the graph.replay ns
    nested in it, per add; nothing where the program has no adder span."""
    got = harness.load_reader("circuit.host_ms.adder8", PKG)(
        _ctx(None, [], counts))
    assert got == (None if want is None else pytest.approx(want))


TINY = {"lwe_dimension": 8, "glwe_dimension": 2, "polynomial_size": 64,
        "lwe_modular_std_dev": 2.0 ** -25, "glwe_modular_std_dev": 2.0 ** -28,
        "pbs_base_log": 8, "pbs_level": 2, "ks_base_log": 2, "ks_level": 5}


@pytest.mark.parametrize("flip", [False, True], ids=["sound", "flipped"])
def test_check_catches_one_flipped_word(flip):
    """The cell's check, on the CPU at 2 bits and tiny parameters: 0
    mismatched words on the program's answer, and `correct` false when one
    word of it is flipped."""
    mix = {"loop": "closed", "sizes": {"kind": "fixed", "rows": 4 * 5},
           "ops": ["add2"], "bits": 2, "tiers": [4], "pool": 1,
           "check_rows": 6}
    system = boolean_adder.System({"parameters": TINY}, mix, "cpu", 2 ** 33)
    system.setup()
    system.prepare_closed(mix["pool"], mix["sizes"]["rows"])
    req = traffic.closed_request(mix, 2 ** 33, 0)
    system.attach(req)
    system.keep(req, system.call(req))
    if flip:
        system.kept[req.id][1, 0, 3] ^= 1 << 20
    checks = system.check([req])
    assert checks["mismatched_words"][0] == (1 if flip else 0)
    assert checks["rows_checked"][0] >= 1
    assert harness.judge(checks, 0) is not flip


@pytest.mark.cuda
def test_adder_issues_its_gates_without_a_host_sync():
    """On the card (skipped elsewhere): once the gates' graphs are warmed,
    an add of device-resident bit planes makes no call that waits for the
    card (torch's sync debug mode raises on one), and its answer is the
    CPU key's and a + b."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params = BooleanParameters(8, 2, 512, StandardDev(2.0 ** -25),
                               StandardDev(2.0 ** -28), 8, 2, 2, 5)
    gen, p, ref, sks = _keys(params, 26, "cuda")
    sks.warmup(batch_sizes=(16,), gates=("xor", "and"), mux=True)
    a, b = (torch.randint(0, 256, (16,), generator=gen, device="cuda")
            for _ in range(2))
    a_ct, b_ct = (plain_adder.encrypt(gen, ref, p, v, BITS).to(torch.int32)
                  for v in (a, b))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sums, carry = circuits.ripple_carry_adder(sks, a_ct, b_ct)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = circuits.ripple_carry_adder(sks.to("cpu"), a_ct.cpu(), b_ct.cpu())
    assert torch.equal(sums.cpu(), want[0])
    assert torch.equal(carry.cpu(), want[1])
    got = sums.to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(plain_adder.decrypt(ref, got), (a + b) % 256)
