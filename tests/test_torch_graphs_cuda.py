"""The port's captured CUDA graphs (ops/graphs.py) on the GPU: every
replay equal to the eager call on the card and to the plain versions on the
CPU, bit for bit, on fresh inputs each call; gates and tiers of one key
replayed in an order unlike their capture order; launches counted per
replay as an eager call counts them; a fast-mode twin with graphs of its
own; a capture that meets a copy from the host raising, never running
eagerly instead.

Marked `cuda`: these tests need an NVIDIA Hopper GPU and nvcc, and skip
anywhere else (the check runs inside a fixture, never at import). On a GPU
machine (where JAX, which tests/conftest.py imports, may be absent):
    python -m pytest --noconftest tests/test_torch_graphs_cuda.py"""

import dataclasses
import gc
from pathlib import Path

import numpy as np
import pytest
import torch

from concrete_tpu_torch import boolean, torus
from concrete_tpu_torch.boolean import server_key as sk
from concrete_tpu_torch.core import bootstrap as bs
from concrete_tpu_torch.core import bootstrap_mxu as bsx
from concrete_tpu_torch.core import bootstrap_ntt as bsntt
from concrete_tpu_torch.core import bootstrap_nuss as bsn
from concrete_tpu_torch.core import lwe as lwe_ops
from concrete_tpu_torch.core.ggsw import bsk_to_ntt
from concrete_tpu_torch.dispersion import StandardDev
from concrete_tpu_torch.ops import _cuda, graphs
from concrete_tpu_torch.params import BooleanParameters

pytestmark = pytest.mark.cuda

UNSIGNED = {32: np.uint32, 64: np.uint64}
COUNTED = (bsx, bsn, bsntt)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        pytest.skip("needs nvcc")
    _cuda.load_all()
    return torch.device("cuda")


def _rand(rng, shape, bits, dev="cpu"):
    dt = UNSIGNED[bits]
    return torus.from_numpy(rng.integers(0, np.iinfo(dt).max, size=shape,
                                         dtype=dt, endpoint=True), dev)


def _reset():
    for mod in COUNTED:
        mod.reset_launch_counts()


def _counts():
    return ({k: v for m in COUNTED for k, v in m.launch_counts().items()},
            {k: v for m in COUNTED for k, v in m.shape_counts().items()})


def _key_forms(backend, cfg, bsk, ksk):
    if backend == "mxu":
        return (torus.from_numpy(bsx.bsk_to_mxu(bsk, cfg)),
                bsx.jit_bootstrap_keyswitch_mxu(cfg), bsx.bootstrap_keyswitch_mxu)
    if backend == "nuss":
        return (bsn.bsk_to_nuss(bsk, cfg), bsn.jit_bootstrap_keyswitch_nuss(cfg),
                bsn.bootstrap_keyswitch_nuss)
    return (bsk_to_ntt(bsk, cfg.primes, cfg.bits),
            bsntt.jit_bootstrap_keyswitch(cfg), bsntt.bootstrap_keyswitch)


# (backend, bits, n, k, N, base_log, level): K2 / K4 + K1 (mxu), K7 + K1 +
# K5 / K6 (nuss, L = 8), K9 / the torch composition (ntt), each torus
JIT_CASES = [("mxu", 32, 12, 2, 256, 8, 2), ("mxu", 64, 10, 1, 256, 7, 3),
             ("nuss", 32, 6, 1, 256, 7, 2), ("nuss", 64, 6, 1, 256, 10, 2),
             ("ntt", 32, 6, 1, 256, 7, 2), ("ntt", 64, 6, 1, 512, 7, 3)]


@pytest.mark.parametrize("backend,bits,n,k,N,bl,lv", JIT_CASES)
def test_jit_replay_equals_eager_and_cpu(dev, backend, bits, n, k, N, bl, lv):
    """Three calls of a jit entry point, fresh inputs each (a graph that
    ignored its inputs would repeat the first answer): each replay equal
    to the eager call on the card and on the CPU (the plain versions);
    the launches of a replay equal an eager call's, total and by shape."""
    cfg = bs.ServerConfig(lwe_dimension=n, glwe_dimension=k, polynomial_size=N,
                          pbs_base_log=bl, pbs_level=lv, ks_base_log=2,
                          ks_level=5, bits=bits)
    rng = np.random.default_rng(n + N + bits)
    bsk = rng.integers(0, np.iinfo(UNSIGNED[bits]).max,
                       size=(n, lv, k + 1, k + 1, N), dtype=UNSIGNED[bits],
                       endpoint=True)
    ksk = rng.integers(0, np.iinfo(UNSIGNED[bits]).max, size=(k * N, 5, n + 1),
                       dtype=UNSIGNED[bits], endpoint=True)
    bsk_cpu, jit, eager = _key_forms(backend, cfg, bsk, ksk)
    ksk8 = torch.from_numpy(lwe_ops.ksk_to_limbs(ksk))
    keys = (bsk_cpu.to(dev), ksk8.to(dev))
    outs = []
    for call in range(3):
        lut, lwe = _rand(rng, (k + 1, N), bits), _rand(rng, (33, n + 1), bits)
        _reset()
        want = eager(cfg, *keys, lut.to(dev), lwe.to(dev))
        torch.cuda.synchronize()
        eager_counts = _counts()
        _reset()
        got = jit(*keys, lut.to(dev), lwe.to(dev))
        torch.cuda.synchronize()
        if call:       # the first call also runs fn once before its capture
            assert _counts() == eager_counts
        assert len(jit.graphs) == 1
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), eager(cfg, bsk_cpu, ksk8, lut, lwe))
        outs.append(got)
    assert not torch.equal(outs[1], outs[2])
    if backend != "ntt" or bits == 32:
        assert sum(_counts()[0].values()) > 0


def _key(dev, backend, level=2):
    tiny = BooleanParameters(16, 1, 256, StandardDev(2.0 ** -25),
                             StandardDev(2.0 ** -30), 7, level, 4, 3)
    cks, sks = boolean.gen_keys(tiny, secret_seed=1, mask_seed=2, noise_seed=3,
                                device=dev)
    return cks, dataclasses.replace(sks, backend=backend)


def _eager(sks, name, cts):
    """The gate's pipeline called eagerly on the card (no graph)."""
    keys = sks.gate_keys()
    if name == "mux":
        return sk._mux_pipeline(sks.cfg, sks.resolved_backend())(*keys, *cts)
    return sk._gate_pipeline(sks.cfg, sks.resolved_backend(), name)(*keys,
                                                                    *cts[:2])


@pytest.mark.parametrize("backend", ["mxu", "nuss", "ntt"])
def test_shuffled_replays_across_gates_and_tiers(dev, backend):
    """AND, XOR and MUX warmed at two tiers of one key (one memory pool),
    then replayed in an order unlike the capture order, fresh ciphertexts
    each call: every output equal to the eager pipeline's, to the CPU's and
    to its truth table, and each call's launches an eager call's."""
    cks, sks = _key(dev, backend)
    tiers = (16, 64)
    warm = sks.warmup(tiers, gates=("and", "xor"), mux=True)
    assert set(warm) == {(g, t) for g in ("and", "xor", "mux") for t in tiers}
    cpu = sks.to("cpu")
    rng = np.random.default_rng(5)
    order = [("mux", 64), ("and", 16), ("xor", 64), ("mux", 16), ("and", 64),
             ("xor", 16), ("and", 16), ("mux", 64)]
    for i, (name, rows) in enumerate(order):
        bits = rng.integers(0, 2, size=(3, rows)).astype(bool)
        cts = [torus.from_numpy(cks.encrypt(v, mask_seed=100 + 3 * i + j,
                                            noise_seed=200 + 3 * i + j), dev)
               for j, v in enumerate(bits)]
        _reset()
        want = _eager(sks, name, cts)
        torch.cuda.synchronize()
        eager_counts = _counts()
        _reset()
        got = sks.mux(*cts) if name == "mux" else sks._run_gate(name, *cts[:2])
        torch.cuda.synchronize()
        assert _counts() == eager_counts
        assert torch.equal(got, want)
        cpu_got = (cpu.mux(*cts) if name == "mux"
                   else cpu._run_gate(name, *[c.cpu() for c in cts[:2]]))
        assert torch.equal(got.cpu(), cpu_got)
        a, b, c = bits
        truth = {"and": a & b, "xor": a ^ b, "mux": np.where(a, b, c)}[name]
        np.testing.assert_array_equal(cks.decrypt(got), truth)
    calls = sks.evaluation.graphs.values()
    assert {c.name for c in calls} == {f"{g} ({backend})"
                                       for g in ("and", "xor", "mux")}
    assert sum(len(c.graphs) for c in calls) == 6


def test_fast_mode_twin_has_graphs_of_its_own(dev):
    """A fast-mode twin (levels=2 of 3) made after its parent's graphs
    replays its own keys: its AND equals its eager pipeline and differs
    from the parent's on the same input."""
    cks, sks = _key(dev, "mxu", level=3)
    sks.warmup([32])
    fast = sks.with_fast_mode(levels=2)
    assert fast.evaluation.graphs == {}
    assert fast.evaluation.pool is not sks.evaluation.pool
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, size=(2, 32)).astype(bool)
    cts = [torus.from_numpy(cks.encrypt(v, mask_seed=7 + j, noise_seed=9 + j),
                            dev) for j, v in enumerate(bits)]
    parent, twin = sks.and_(*cts), fast.and_(*cts)
    assert torch.equal(twin, _eager(fast, "and", cts))
    assert torch.equal(parent, _eager(sks, "and", cts))
    assert not torch.equal(twin, parent)
    np.testing.assert_array_equal(cks.decrypt(twin), bits[0] & bits[1])


def test_graph_is_dropped_with_its_key(dev):
    call = graphs.GraphedCall(lambda key, x: key * x, 1)
    key = torch.arange(4, device=dev)
    assert torch.equal(call(key, torch.ones(4, dtype=torch.int64, device=dev)),
                       key)
    assert len(call.graphs) == 1
    del key
    assert not call.graphs


def test_a_dead_graph_in_a_cycle_does_not_break_a_capture(dev):
    """Inside a capture, the last reference to a captured graph goes into
    a dead reference cycle, and 20,000 lists are made against a young
    generation's threshold of 700 (pinned here), enough to start the
    cyclic collector many times over: the capture runs no collection (one
    there would destroy the dead graph, which invalidates the capture),
    and the graph goes at the next collection after it."""
    x = torch.arange(8, device=dev)
    held = graphs.GraphedCall(lambda x: x * 2)
    assert torch.equal(held(x), x * 2)
    state = {"calls": 0, "held": held}
    del held

    def drops_a_graph(x):
        state["calls"] += 1
        if state["calls"] == 2:          # the capture (1: its warm run)
            cycle = {"call": state.pop("held")}
            cycle["self"] = cycle
            del cycle
            junk = [[] for _ in range(20_000)]
            assert junk
        return x + 1

    assert gc.isenabled()
    threshold = gc.get_threshold()
    gc.set_threshold(700, 10, 10)
    try:
        call = graphs.GraphedCall(drops_a_graph)
        assert torch.equal(call(x), x + 1) and len(call.graphs) == 1
    finally:
        gc.set_threshold(*threshold)
    assert gc.isenabled()
    gc.collect()
    assert torch.equal(call(x + 1), x + 2)


def test_capture_of_a_host_copy_raises(dev):
    """A function that copies from the host inside the capture: the call
    raises GraphCaptureError naming that line, returns nothing, keeps no
    graph and leaves the counters and the card as they were (a later
    capture works)."""
    host = torch.ones(8, dtype=torch.int32)

    def copies_from_host(x):
        return x + host.to(x.device)

    call = graphs.GraphedCall(copies_from_host, name="host copy")
    x = torch.arange(8, dtype=torch.int32, device=dev)
    before = graphs.snapshot()
    for _ in range(2):
        with pytest.raises(graphs.GraphCaptureError, match="copies_from_host"):
            call(x)
        assert not call.graphs
    assert graphs.snapshot() == before
    ok = graphs.GraphedCall(lambda x: x + 1)
    assert torch.equal(ok(x), x + 1)
    assert torch.equal(torch.zeros(2, device=dev).cpu(), torch.zeros(2))
