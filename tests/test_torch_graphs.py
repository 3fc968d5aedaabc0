"""The port's one-dispatch entry points on the CPU, held bit for bit
against concrete_tpu's jitted ones: jit_bootstrap_keyswitch_mxu /
_nuss / jit_bootstrap_keyswitch on both tori, ServerKey's _gate_pipeline
for the six gates and _mux_pipeline. On CPU tensors a GraphedCall
(ops/graphs.py) runs its function, so these hold the functions that the
card captures; tests/test_torch_graphs_cuda.py holds the graphs' replays
to the eager calls on the card. Also the launch accounting of a capture
and the graph cache of a key whose keys change, on ServerKey and LWEBSK."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from concrete_tpu import boolean as boolean_jax
from concrete_tpu.boolean import server_key as sk_jax
from concrete_tpu.core import bootstrap as bs_jax
from concrete_tpu.core import bootstrap_mxu as bsx_jax
from concrete_tpu.core import bootstrap_nuss as bsn_jax
from concrete_tpu.core import lwe as lwe_jax
from concrete_tpu.core.ggsw import bsk_to_ntt as bsk_to_ntt_jax
from concrete_tpu_torch import boolean as boolean_t
from concrete_tpu_torch import highlevel as hl_t
from concrete_tpu_torch import torus
from concrete_tpu_torch.boolean import server_key as sk_t
from concrete_tpu_torch.core import bootstrap as bs_t
from concrete_tpu_torch.core import bootstrap_mxu as bsx_t
from concrete_tpu_torch.core import bootstrap_ntt as bsntt_t
from concrete_tpu_torch.core import bootstrap_nuss as bsn_t
from concrete_tpu_torch.core import lwe as lwe_t
from concrete_tpu_torch.core.ggsw import bsk_to_ntt as bsk_to_ntt_t
from concrete_tpu_torch.ops import _cuda, graphs

from common import TINY, TINY_K2

UNSIGNED = {32: np.uint32, 64: np.uint64}
GATES = ("and", "nand", "or", "nor", "xor", "xnor")


def _cfgs(n, k, N, bl, lv, ks_bl, ks_l, bits):
    kw = dict(lwe_dimension=n, glwe_dimension=k, polynomial_size=N,
              pbs_base_log=bl, pbs_level=lv, ks_base_log=ks_bl,
              ks_level=ks_l, bits=bits)
    return bs_jax.ServerConfig(**kw), bs_t.ServerConfig(**kw)


def _from_params(p):
    return _cfgs(p.lwe_dimension, p.glwe_dimension, p.polynomial_size,
                 p.pbs_base_log, p.pbs_level, p.ks_base_log, p.ks_level, 32)


# (backend, configuration): TINY / TINY_K2 (tests/common.py) for mxu and
# ntt, small Nussbaumer rings (L = 8 and 4), and the u64 torus on each
CASES = {
    "mxu tiny": ("mxu", _from_params(TINY)),
    "mxu tiny_k2": ("mxu", _from_params(TINY_K2)),
    "mxu u64": ("mxu", _cfgs(6, 1, 64, 7, 3, 2, 8, 64)),
    "nuss u32": ("nuss", _cfgs(4, 1, 256, 8, 2, 4, 3, 32)),
    "nuss u64": ("nuss", _cfgs(3, 2, 128, 7, 2, 2, 8, 64)),
    "ntt tiny": ("ntt", _from_params(TINY)),
    "ntt tiny_k2": ("ntt", _from_params(TINY_K2)),
    "ntt u64": ("ntt", _cfgs(6, 1, 64, 7, 3, 2, 8, 64)),
}


def _rand(rng, shape, bits):
    dt = UNSIGNED[bits]
    return rng.integers(0, np.iinfo(dt).max, size=shape, dtype=dt,
                        endpoint=True)


@pytest.mark.parametrize("case", list(CASES))
def test_jit_bootstrap_keyswitch_matches_jax(case):
    """The port's jit entry point of each backend against concrete_tpu's on
    random keys, LUT and ciphertexts, bit for bit; the eager function the
    graph captures gives the same bits."""
    backend, (cj, ct) = CASES[case]
    bits, n, ks1, N = ct.bits, ct.lwe_dimension, ct.glwe_size, ct.polynomial_size
    rng = np.random.default_rng(len(case))
    bsk = _rand(rng, (n, ct.pbs_level, ks1, ks1, N), bits)
    ksk = _rand(rng, (ct.big_lwe_dimension, ct.ks_level, n + 1), bits)
    lut = _rand(rng, (ks1, N), bits)
    lwe = _rand(rng, (4, n + 1), bits)
    ksk8_t = torch.from_numpy(lwe_t.ksk_to_limbs(ksk))
    if backend == "mxu":
        keys_j = (jnp.asarray(bsx_jax.bsk_to_mxu(bsk, cj)),
                  jnp.asarray(lwe_jax.ksk_to_limbs(ksk)))
        fn_j = bsx_jax.jit_bootstrap_keyswitch_mxu(cj)
        bsk_t = torus.from_numpy(bsx_t.bsk_to_mxu(bsk, ct))
        fn_t, eager = (bsx_t.jit_bootstrap_keyswitch_mxu(ct),
                       bsx_t.bootstrap_keyswitch_mxu)
    elif backend == "nuss":
        keys_j = (jnp.asarray(bsn_jax.bsk_to_nuss(bsk, cj)),
                  jnp.asarray(lwe_jax.ksk_to_limbs(ksk)))
        fn_j = bsn_jax.jit_bootstrap_keyswitch_nuss(cj)
        bsk_t = bsn_t.bsk_to_nuss(bsk, ct)
        fn_t, eager = (bsn_t.jit_bootstrap_keyswitch_nuss(ct),
                       bsn_t.bootstrap_keyswitch_nuss)
    else:
        keys_j = (bsk_to_ntt_jax(bsk, cj.primes, bits), jnp.asarray(ksk))
        fn_j = bs_jax.jit_bootstrap_keyswitch(cj)
        bsk_t = bsk_to_ntt_t(bsk, ct.primes, bits, device="cpu")
        fn_t, eager = (bsntt_t.jit_bootstrap_keyswitch(ct),
                       bsntt_t.bootstrap_keyswitch)
    want = np.asarray(fn_j(*keys_j, jnp.asarray(lut), jnp.asarray(lwe)))
    args = (bsk_t, ksk8_t, torus.from_numpy(lut), torus.from_numpy(lwe))
    got = fn_t(*args)
    assert isinstance(fn_t, graphs.GraphedCall) and fn_t.n_static == 2
    assert got.dtype == torus.carrier(bits) and got.shape == (4, n + 1)
    np.testing.assert_array_equal(torus.to_numpy(got), want)
    assert torch.equal(eager(ct, *args), got)


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    """concrete_tpu's TINY keys, loaded by the port from their npz files,
    and three ciphertext batches of 8 rows."""
    cks, sks = boolean_jax.gen_keys(TINY, secret_seed=4, mask_seed=5,
                                    noise_seed=6)
    d = tmp_path_factory.mktemp("graph_keys")
    sks.save(str(d / "server.npz"))
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, size=(3, 8)).astype(bool)
    cts = [cks.encrypt(v, mask_seed=30 + i, noise_seed=40 + i)
           for i, v in enumerate(bits)]
    port = boolean_t.ServerKey.load(str(d / "server.npz"), device="cpu")
    return cks, sks, port, bits, cts, d / "server.npz"


def _pipelines(keys, backend, name):
    """(concrete_tpu's result, the port pipeline's, the port key's gate
    call) for gate or "mux" `name` on `backend`."""
    cks, sks, port, bits, cts, _ = keys
    sj = dataclasses.replace(sks, backend=backend)
    st = dataclasses.replace(port, backend=backend)
    keys_j = (sj._bootstrap_keys(), sj._keyswitch_key())
    keys_t = st.gate_keys()
    ins_t = [torus.from_numpy(c) for c in cts]
    if name == "mux":
        want = sk_jax._mux_pipeline(sj.cfg, backend)(*keys_j, *cts)
        got = sk_t._mux_pipeline(st.cfg, backend)(*keys_t, *ins_t)
        call = st.mux(*cts)
    else:
        want = sk_jax._gate_pipeline(sj.cfg, backend, name)(*keys_j, *cts[:2])
        got = sk_t._gate_pipeline(st.cfg, backend, name)(*keys_t, *ins_t[:2])
        call = st._run_gate(name, *cts[:2])
    return np.asarray(want), got, call


@pytest.mark.parametrize("backend,name", [("mxu", g) for g in GATES + ("mux",)]
                         + [(b, g) for b in ("ntt", "nuss") for g in ("and", "mux")])
def test_gate_pipelines_match_jax(keys, backend, name):
    """Each gate's pipeline and MUX's against concrete_tpu's on the same
    keys and ciphertexts; the key's gate call (its GraphedCall) the same."""
    cks, bits = keys[0], keys[3]
    want, got, call = _pipelines(keys, backend, name)
    np.testing.assert_array_equal(torus.to_numpy(got), want)
    assert torch.equal(call, got)
    a, b, c = bits
    truth = {"and": a & b, "nand": ~(a & b), "or": a | b, "nor": ~(a | b),
             "xor": a ^ b, "xnor": ~(a ^ b), "mux": np.where(a, b, c)}[name]
    np.testing.assert_array_equal(cks.decrypt(want), truth)


def test_launch_accounting_of_a_capture():
    """What a capture adds to the counters is recorded and taken back out;
    each replay adds the record, shape keys included."""

    def kernel():
        pass

    kernel = _cuda.counter(kernel)
    _cuda.count_launch(kernel, B=8)          # a launch before the capture
    before = graphs.snapshot()
    for b in (8, 8, 16):                    # what the capture records
        _cuda.count_launch(kernel, B=b)
    record = graphs.count_record(before, graphs.snapshot())
    assert record[kernel] == (3, {"B=8": 2, "B=16": 1})
    graphs.add_counts(record, -1)
    assert (kernel.launches, kernel.shapes) == (1, {"B=8": 1})
    for _ in range(2):                      # two replays
        graphs.add_counts(record)
    assert (kernel.launches, kernel.shapes) == (7, {"B=8": 5, "B=16": 2})
    assert all(k is kernel for k in record)  # other counters unrecorded


def test_capture_error_names_the_line_that_broke_it():
    """A capture refused twice (the op, then the end of the capture) is
    reported at the first error's innermost line outside torch."""

    def copy_from_host():
        raise RuntimeError("operation not permitted when stream is capturing")

    try:
        try:
            copy_from_host()
        except RuntimeError:
            raise RuntimeError("capture invalidated")
    except RuntimeError as exc:
        where, first = graphs._origin(exc)
    assert "copy_from_host" in where and __file__ in where
    assert str(first).startswith("operation not permitted")


def test_graphed_call_on_the_cpu_runs_its_function():
    seen = []

    def fn(key, x):
        seen.append(x)
        return key + x

    call = graphs.GraphedCall(fn, 1)
    assert torch.equal(call(torch.ones(3), torch.arange(3.0)),
                       torch.tensor([1.0, 2.0, 3.0]))
    assert len(seen) == 1 and not call.graphs
    with pytest.raises(TypeError):
        call(torch.ones(3), [1, 2, 3])


@pytest.fixture(scope="module")
def hl_key(tmp_path_factory):
    """A tiny LWEBSK on the CPU, its file, and fn(key) running its PBS on
    an accumulator and two ciphertexts (u64)."""
    sk = hl_t.LWESecretKey.new(hl_t.LWEParams(8, -40), secret_seed=1)
    rsk = hl_t.RLWESecretKey.new(hl_t.RLWEParams(64, 1, -50), secret_seed=2)
    bsk = hl_t.LWEBSK.new(sk, rsk, 7, 3, mask_seed=3, noise_seed=4,
                          device="cpu")
    path = tmp_path_factory.mktemp("hl_graph_keys") / "bsk.npz"
    bsk.save(str(path))
    rng = np.random.default_rng(6)
    acc = np.zeros((2, 64), np.uint64)
    acc[1] = rng.integers(0, 1 << 63, 64, dtype=np.uint64)
    cts = rng.integers(0, 1 << 63, (2, 9), dtype=np.uint64)
    return bsk, path, lambda k: k.run_bootstrap(acc, cts)


def _key_case(kind, keys, hl_key):
    """A key of `kind` on mxu made by plain dataclasses.replace, fn(key)
    running it, the names of the graphs that run makes, and its class and
    file (load)."""
    if kind == "ServerKey":
        _, _, port, _, cts, path = keys
        return (dataclasses.replace(port, backend="mxu"),
                lambda k: k.and_(*cts[:2]), {"and (mxu)"},
                boolean_t.ServerKey, path)
    bsk, path, run = hl_key
    return (dataclasses.replace(bsk, backend="mxu"), run, {"pbs (mxu)"},
            hl_t.LWEBSK, path)


@pytest.mark.parametrize("kind", ["ServerKey", "LWEBSK"])
def test_graph_cache_is_new_where_the_keys_change(keys, hl_key, kind):
    """with_fast_mode, to (ServerKey's) and load give a key whose graphs,
    pool (and warmed tiers) start empty: a copy sharing its parent's graphs
    would replay the parent's keys. `to` moves the forms."""
    key, run, names, cls, path = _key_case(kind, keys, hl_key)
    ev = key.evaluation
    if kind == "ServerKey":
        key.warmup([8], gates=("and",), mux=True)
        assert key._warmed_tiers == {8}
        names = names | {"mux (mxu)"}
    else:
        run(key)
    assert {c.name for c in ev.graphs.values()} == names
    assert all(c.pool is ev.pool for c in ev.graphs.values())
    copies = [key.with_fast_mode(), cls.load(str(path), device="cpu")]
    if kind == "ServerKey":
        copies.append(key.to("cpu"))
        assert set(copies[-1].evaluation.forms) == set(ev.forms) == {"mxu"}
    for copy in copies:
        assert copy.evaluation.graphs == {} and copy.evaluation is not ev
        assert copy.evaluation.pool is not ev.pool
        assert getattr(copy, "_warmed_tiers", set()) == set()
    fast = key.with_fast_mode(levels=1)
    run(fast)
    (call,) = fast.evaluation.graphs.values()
    assert fast.evaluation.cfg == fast.cfg and fast.cfg.pbs_level == 1
    assert fast.bsk_mxu.shape[1] == key.bsk_mxu.shape[1] // key.cfg.pbs_level
    assert call not in ev.graphs.values()
    assert {c.name for c in ev.graphs.values()} == names


@pytest.mark.parametrize("kind", ["ServerKey", "LWEBSK"])
def test_replaced_backend_runs_with_graphs_of_its_own(keys, hl_key, kind):
    """dataclasses.replace(key, backend="ntt") alone gives a key that runs
    the ntt backend, with a form, graphs and a pool of its own, and the
    bits of its mxu parent (the backends are bit-identical)."""
    key, run, names, _, _ = _key_case(kind, keys, hl_key)
    want = run(key)
    other = dataclasses.replace(key, backend="ntt")
    assert torch.equal(run(other), want)
    assert other.resolved_backend() == "ntt"
    assert set(other.evaluation.forms) == {"ntt"}
    assert set(key.evaluation.forms) == {"mxu"}
    assert {c.name for c in other.evaluation.graphs.values()} == {
        n.replace("(mxu)", "(ntt)") for n in names}
    assert {c.name for c in key.evaluation.graphs.values()} == names
    assert other.evaluation.pool is not key.evaluation.pool
