"""The compiled calls the port captures as CUDA graphs beyond the gate
(ops/graphs.py), held on the CPU against concrete_tpu: the four sharded
pipelines of parallel/mesh.py, which concrete_tpu compiles with
jax.jit(shard_map(...)), and LWEBSK.run_bootstrap / run_bootstrap_many,
whose blind rotation concrete_tpu runs as one compiled lax.scan. On CPU
tensors a GraphedCall runs its function, so these hold the functions the
card captures; tests/test_torch_parallel_graphs_cuda.py holds the replays
to the eager calls on the card. Also the accounting of a plain counter
(the bytes handed to collectives) under capture and replay. Tolerance:
none."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from concrete_tpu import highlevel as hl_jax
from concrete_tpu.core import bootstrap as jbs
from concrete_tpu.core import bootstrap_mxu as jbsx
from concrete_tpu.parallel import mesh as jmesh
from concrete_tpu_torch import highlevel as hl_t
from concrete_tpu_torch import torus
from concrete_tpu_torch.core import bootstrap_mxu as bsx
from concrete_tpu_torch.core import bootstrap_nuss as bsn
from concrete_tpu_torch.core import lwe as lwe_ops
from concrete_tpu_torch.core.ggsw import bsk_to_ntt
from concrete_tpu_torch.ops import graphs
from concrete_tpu_torch.parallel import dryrun, mesh

# dryrun's configurations, one a torus; the nuss pipeline's chunk count
CONFIGS = {"u32 bl8": 4, "u64": 4}
BATCH = 8


def test_counter_accounting_of_a_capture():
    """What a capture adds to a plain counter is recorded and taken back
    out, a key it left at 0 going; each replay adds the record."""
    sent = graphs.Counter("test_bytes")
    sent.add(16, "broadcast")                   # before the capture
    before = graphs.snapshot()
    sent.add(64, "all_reduce")                  # what the capture records
    sent.add(64, "all_reduce")
    sent.add(8, "broadcast")
    record = graphs.count_record(before, graphs.snapshot())
    assert record == {sent: (136, {"all_reduce": 128, "broadcast": 8})}
    graphs.add_counts(record, -1)
    assert (sent.total, sent.by_key) == (16, {"broadcast": 16})
    for _ in range(3):                          # three replays
        graphs.add_counts(record)
    assert (sent.total, sent.by_key) == (424, {"all_reduce": 384,
                                               "broadcast": 40})
    sent.reset()
    assert (sent.total, sent.by_key) == (0, {})


def test_sent_bytes_is_a_registered_counter():
    """mesh.sent_bytes() reads a Counter, so a replayed pipeline's
    collectives count per replay."""
    assert isinstance(mesh.SENT, graphs.Counter)
    assert mesh.SENT in graphs.snapshot()


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    """An in-process gloo group of one rank and its 1 x 1 mesh."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield mesh.make_mesh(1, 1, "cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    """(config, port inputs by key form, concrete_tpu's jitted dp pipeline
    on a 1 x 1 mesh): one JAX reference per configuration, which every
    pipeline must equal, as every backend computes the same bits."""
    config = request.param
    spec = dryrun.CONFIGS[config]
    cfg = spec["cfg"]
    inp = dryrun.case_inputs(config, "mxu", BATCH)
    cfg_j = jbs.ServerConfig(**dataclasses.asdict(cfg))
    want = np.asarray(jmesh.gate_pipeline_dp(
        cfg_j, jmesh.make_mesh(1, 1), "mxu")(
        jnp.asarray(jbsx.bsk_to_mxu(inp["bsk"], cfg_j)), jnp.asarray(inp["ksk"]),
        jnp.asarray(inp["lut"]), jnp.asarray(inp["lin"])))
    ksk8 = torch.from_numpy(lwe_ops.ksk_to_limbs(inp["ksk"]))
    rest = (ksk8, torus.from_numpy(inp["lut"], bits=cfg.bits),
            torus.from_numpy(inp["lin"], bits=cfg.bits))
    keys = {"mxu": torus.from_numpy(bsx.bsk_to_mxu(inp["bsk"], cfg)),
            "ntt": bsk_to_ntt(inp["bsk"], cfg.primes, cfg.bits, device="cpu"),
            "nuss": bsn.bsk_to_nuss(inp["bsk"], cfg, CONFIGS[config])}
    return config, {k: (v,) + rest for k, v in keys.items()}, want


FACTORIES = {
    "dp mxu": ("mxu", ("dp", "tp"),
               lambda cfg, m, lc: mesh.gate_pipeline_dp(cfg, m, "mxu")),
    "dp ntt": ("ntt", ("dp", "tp"),
               lambda cfg, m, lc: mesh.gate_pipeline_dp(cfg, m, "ntt")),
    "dp_tp": ("ntt", ("dp",), lambda cfg, m, lc: mesh.gate_pipeline_dp_tp(
        cfg, m)),
    "dp_tp_mxu": ("mxu", ("dp",),
                  lambda cfg, m, lc: mesh.gate_pipeline_dp_tp_mxu(cfg, m)),
    "dp_tp_nuss": ("nuss", ("dp",),
                   lambda cfg, m, lc: mesh.gate_pipeline_dp_tp_nuss(cfg, m,
                                                                    l=lc)),
}


@pytest.mark.parametrize("factory", list(FACTORIES))
def test_pipeline_is_a_graphed_call_equal_to_concrete_tpu(world_of_one, case,
                                                          factory):
    """Each factory on a world of one returns a GraphedCall (the two keys
    static) that keeps out_axes, says it is graphed, and gives concrete_tpu's
    jitted pipeline's bits."""
    config, inputs, want = case
    form, axes, make = FACTORIES[factory]
    fn = make(dryrun.CONFIGS[config]["cfg"], world_of_one, CONFIGS[config])
    assert isinstance(fn, graphs.GraphedCall) and fn.n_static == 2
    assert fn.graphed is True and fn.out_axes == axes
    mesh.reset_sent_bytes()
    got = fn(*inputs[form])
    np.testing.assert_array_equal(torus.to_numpy(got), want)
    assert torch.equal(mesh.gather(got, world_of_one, fn.out_axes), got)
    assert mesh.sent_bytes() == 0          # a group of one rank sends nothing


# ---------------------------------------------------------------------------
# the high-level PBS
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["mxu", "nuss"])
def hl_keys(request, tmp_path_factory):
    """concrete_tpu's LWEBSK on `backend` and the port's, loaded from its
    file; an accumulator and 6 ciphertexts (u64 numpy)."""
    sk = hl_jax.LWESecretKey.new(hl_jax.LWEParams(16, -40), secret_seed=1)
    rsk = hl_jax.RLWESecretKey.new(hl_jax.RLWEParams(256, 1, -50),
                                   secret_seed=2)
    bsk_j = dataclasses.replace(
        hl_jax.LWEBSK.new(sk, rsk, 7, 3, mask_seed=3, noise_seed=4),
        backend=request.param)
    path = tmp_path_factory.mktemp("bsk") / "bsk.npz"
    bsk_j.save(str(path))
    bsk_t = hl_t.LWEBSK.load(str(path), device="cpu", backend=request.param)
    rng = np.random.default_rng(5)
    acc = np.zeros((2, 256), np.uint64)
    acc[1] = rng.integers(0, 1 << 63, 256, dtype=np.uint64) << np.uint64(1)
    cts = rng.integers(0, np.iinfo(np.uint64).max, (6, 17), dtype=np.uint64,
                       endpoint=True)
    return bsk_j, bsk_t, acc, cts


def test_highlevel_pbs_equals_concrete_tpu(hl_keys):
    """run_bootstrap and run_bootstrap_many through the key's graphed calls
    give concrete_tpu's bits; one graphed call per lut_count_log (None
    for run_bootstrap), each on the key's pool."""
    bsk_j, bsk_t, acc, cts = hl_keys
    backend = bsk_t.resolved_backend()
    want = np.asarray(bsk_j.run_bootstrap(jnp.asarray(acc), jnp.asarray(cts)))
    got = bsk_t.run_bootstrap(acc, cts)
    np.testing.assert_array_equal(torus.to_numpy(got), want)
    want = np.asarray(bsk_j.run_bootstrap_many(jnp.asarray(acc),
                                               jnp.asarray(cts[:4]), 1))
    got = bsk_t.run_bootstrap_many(acc, cts[:4], 1)
    assert got.shape == (2, 4, 257)
    np.testing.assert_array_equal(torus.to_numpy(got), want)
    ev = bsk_t.evaluation
    assert set(ev.graphs) == {None, 1} and ev.cfg == bsk_t.cfg
    assert {c.name for c in ev.graphs.values()} == {
        f"pbs ({backend})", f"pbs_many_lut lut_count_log=1 ({backend})"}
    assert all(isinstance(c, graphs.GraphedCall) and c.n_static == 1
               and c.pool is ev.pool for c in ev.graphs.values())


def test_highlevel_graph_cache_is_new_where_the_keys_change(tmp_path):
    """with_fast_mode and load give a key whose graphs and pool start
    empty: a key sharing its parent's graphs would replay the parent's
    key tensors and configuration."""
    sk = hl_t.LWESecretKey.new(hl_t.LWEParams(8, -40), secret_seed=1)
    rsk = hl_t.RLWESecretKey.new(hl_t.RLWEParams(64, 1, -50), secret_seed=2)
    bsk = hl_t.LWEBSK.new(sk, rsk, 7, 3, mask_seed=3, noise_seed=4,
                          device="cpu")
    acc = np.zeros((2, 64), np.uint64)
    cts = np.random.default_rng(6).integers(0, 1 << 63, (2, 9),
                                            dtype=np.uint64)
    bsk.run_bootstrap(acc, cts)
    ev = bsk.evaluation
    assert ev.graphs
    bsk.save(str(tmp_path / "bsk.npz"))
    fast = bsk.with_fast_mode(levels=2)
    loaded = hl_t.LWEBSK.load(str(tmp_path / "bsk.npz"), device="cpu")
    for copy in (fast, loaded):
        assert copy.evaluation.graphs == {} and copy.evaluation is not ev
        assert copy.evaluation.pool is not ev.pool
    fast.run_bootstrap(acc, cts)
    (call,) = fast.evaluation.graphs.values()
    assert fast.evaluation.cfg == fast.cfg and fast.cfg.pbs_level == 2
    assert call not in ev.graphs.values() and ev.cfg.pbs_level == 3
