"""The sharded pipelines (parallel/mesh.py) and the high-level PBS
(LWEBSK.run_bootstrap / run_bootstrap_many) replayed from captured CUDA
graphs on the GPU: every replay equal to its eager call and to the
unsharded call, bit for bit, on fresh inputs each call; launches per
replay an eager call's, by shape key; two pipelines sharing a pool
replayed in shuffled order; a bare all_reduce captured on a one-rank NCCL
group replaying right; a tp > 1 pipeline on gloo eager by construction.

Marked `cuda`: these tests need an NVIDIA GPU and nvcc, and skip anywhere
else (the check runs inside a fixture, never at import). On a GPU machine
(where JAX, which tests/conftest.py imports, may be absent):
    python -m pytest --noconftest tests/test_torch_parallel_graphs_cuda.py"""

import json
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from concrete_tpu_torch import highlevel as hl
from concrete_tpu_torch import torus
from concrete_tpu_torch.core import bootstrap_mxu as bsx
from concrete_tpu_torch.core import bootstrap_ntt as bsntt
from concrete_tpu_torch.core import bootstrap_nuss as bsn
from concrete_tpu_torch.core import lwe as lwe_ops
from concrete_tpu_torch.core.ggsw import bsk_to_ntt
from concrete_tpu_torch.ops import _cuda, graphs
from concrete_tpu_torch.parallel import dryrun, mesh, multihost

pytestmark = pytest.mark.cuda

COUNTED = (bsx, bsn, bsntt)
BATCH = 64
L_NUSS = 4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        pytest.skip("needs nvcc")
    _cuda.load_all()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def nccl_mesh(dev):
    """A one-rank NCCL process group in this process and its 1 x 1 mesh."""
    torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield mesh.make_mesh(1, 1, "cuda")
    finally:
        dist.destroy_process_group()


def _reset():
    for mod in COUNTED:
        mod.reset_launch_counts()


def _counts():
    return ({k: v for m in COUNTED for k, v in m.launch_counts().items()},
            {k: v for m in COUNTED for k, v in m.shape_counts().items()})


def _forms(config, dev):
    """The case's key forms on the card (from one raw key), the limb
    keyswitch key and a maker of fresh (lut, lin)."""
    spec = dryrun.CONFIGS[config]
    cfg = spec["cfg"]
    inp = dryrun.case_inputs(config, "mxu", BATCH)
    keys = {"mxu": torus.from_numpy(bsx.bsk_to_mxu(inp["bsk"], cfg), dev),
            "ntt": bsk_to_ntt(inp["bsk"], cfg.primes, cfg.bits, device=dev),
            "nuss": bsn.bsk_to_nuss(inp["bsk"], cfg, L_NUSS, device=dev)}
    ksk8 = torch.from_numpy(lwe_ops.ksk_to_limbs(inp["ksk"])).to(dev)
    rng = np.random.default_rng(len(config))
    dt = torus.UNSIGNED[cfg.bits]

    def fresh():
        lut = torus.from_numpy(rng.integers(0, np.iinfo(dt).max,
                                            size=inp["lut"].shape, dtype=dt,
                                            endpoint=True), dev)
        lin = torus.from_numpy(rng.integers(0, np.iinfo(dt).max,
                                            size=inp["lin"].shape, dtype=dt,
                                            endpoint=True), dev)
        return lut, lin

    return cfg, keys, ksk8, fresh


# pipeline -> (key form, the factory, the unsharded call)
PIPELINES = {
    "dp mxu": ("mxu", lambda cfg, m: mesh.gate_pipeline_dp(cfg, m, "mxu"),
               bsx.bootstrap_keyswitch_mxu),
    "dp ntt": ("ntt", lambda cfg, m: mesh.gate_pipeline_dp(cfg, m, "ntt"),
               bsntt.bootstrap_keyswitch),
    "dp_tp": ("ntt", mesh.gate_pipeline_dp_tp, bsntt.bootstrap_keyswitch),
    "dp_tp_mxu": ("mxu", mesh.gate_pipeline_dp_tp_mxu,
                  bsx.bootstrap_keyswitch_mxu),
    "dp_tp_nuss": ("nuss", lambda cfg, m: mesh.gate_pipeline_dp_tp_nuss(
        cfg, m, l=L_NUSS), lambda cfg, *x: bsn.bootstrap_keyswitch_nuss(
        cfg, *x, l=L_NUSS)),
}


@pytest.mark.parametrize("config", ["u32 bl8", "u64"])
@pytest.mark.parametrize("pipeline", list(PIPELINES))
def test_pipeline_replay_equals_eager_and_unsharded(dev, nccl_mesh, config,
                                                    pipeline):
    """Three calls on fresh inputs: each replay equal to the pipeline's
    eager run and to the unsharded call; after the first (which also runs
    the pipeline once before its capture) the launches of a replay equal
    an eager run's, in total and by shape key; one graph kept."""
    form, make, unsharded = PIPELINES[pipeline]
    cfg, keys, ksk8, fresh = _forms(config, dev)
    fn = make(cfg, nccl_mesh)
    assert isinstance(fn, graphs.GraphedCall) and fn.graphed
    outs = []
    for call in range(3):
        lut, lin = fresh()
        args = (keys[form], ksk8, lut, lin)
        _reset()
        want = fn.fn(*args)
        torch.cuda.synchronize()
        eager_counts = _counts()
        _reset()
        got = fn(*args)
        torch.cuda.synchronize()
        if call:
            assert _counts() == eager_counts
        assert torch.equal(got, want)
        assert torch.equal(got, unsharded(cfg, *args))
        outs.append(got)
    assert len(fn.graphs) == 1
    assert not torch.equal(outs[1], outs[2])
    if form == "mxu":
        assert _counts()[0]["build_tables"] > 0


def test_pipelines_sharing_a_pool_replay_in_shuffled_order(dev, nccl_mesh):
    """The dp mxu and dp_tp_nuss pipelines' bodies graphed into one pool,
    at two batch sizes each, replayed in an order unlike the capture
    order, fresh inputs each call: every output equal to the eager run."""
    cfg, keys, ksk8, fresh = _forms("u32 bl8", dev)
    pool = graphs.GraphPool()
    calls = {name: (PIPELINES[name][0],
                    graphs.GraphedCall(PIPELINES[name][1](cfg, nccl_mesh).fn,
                                       2, name=name, pool=pool))
             for name in ("dp mxu", "dp_tp_nuss")}
    order = [("dp mxu", 64), ("dp_tp_nuss", 32), ("dp_tp_nuss", 64),
             ("dp mxu", 32), ("dp_tp_nuss", 64), ("dp mxu", 64),
             ("dp mxu", 32), ("dp_tp_nuss", 32)]
    for name, rows in order:
        form, call = calls[name]
        lut, lin = fresh()
        args = (keys[form], ksk8, lut, lin[:rows])
        assert torch.equal(call(*args), call.fn(*args))
    assert all(len(c.graphs) == 2 for _, c in calls.values())


def test_captured_all_reduce_replays_on_fresh_inputs(dev, nccl_mesh):
    """A bare dist.all_reduce captured on the one-rank NCCL group: each
    replay sums (here: keeps) its fresh input, and mesh.sent_bytes counts
    nothing for a group of one rank. The one-card proof that a collective
    survives capture; a sum across two cards is not measured here."""
    group = nccl_mesh.get_group("tp")

    def summed(x):
        y = x * 3
        return mesh._all_reduce(y, group) + 1

    call = graphs.GraphedCall(summed, name="all_reduce")
    rng = np.random.default_rng(9)
    mesh.reset_sent_bytes()
    for _ in range(3):
        x = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, size=(4, 1024),
                                          dtype=np.int64)).to(dev)
        assert torch.equal(call(x), x * 3 + 1)
    assert len(call.graphs) == 1 and mesh.sent_bytes() == 0


@pytest.mark.parametrize("backend,n,N", [("mxu", 630, 1024),
                                         ("nuss", 100, 8192)])
def test_highlevel_replay_equals_eager(dev, backend, n, N):
    """LWEBSK at the int4 shapes (u64 mxu: K4 + K1) and at N=8192 (nuss: K7,
    K1, K6): run_bootstrap and run_bootstrap_many replayed, fresh
    ciphertexts each call, equal to the backend's eager function; launches
    per replay an eager call's."""
    sk = hl.LWESecretKey.new(hl.LWEParams(n, -40), secret_seed=11)
    rsk = hl.RLWESecretKey.new(hl.RLWEParams(N, 1, -62), secret_seed=12)
    bsk = hl.LWEBSK.new(sk, rsk, 7, 3, mask_seed=13, noise_seed=14,
                        device=dev, backend=backend)
    key = bsk.bsk_mxu if backend == "mxu" else bsk.bsk_nuss
    pbs = bsx.bootstrap_mxu if backend == "mxu" else bsn.bootstrap_nuss
    many = (bsx.bootstrap_many_lut_mxu if backend == "mxu"
            else bsn.bootstrap_many_lut_nuss)
    rng = np.random.default_rng(15)
    acc = np.zeros((2, N), np.uint64)
    acc[1] = rng.integers(0, 1 << 63, N, dtype=np.uint64)
    acc_t = torus.from_numpy(acc, dev)
    for call in range(3):
        cts = rng.integers(0, np.iinfo(np.uint64).max, (32, n + 1),
                           dtype=np.uint64, endpoint=True)
        cts_t = torus.from_numpy(cts, dev)
        _reset()
        want = pbs(bsk.cfg, key, acc_t, cts_t)
        torch.cuda.synchronize()
        eager_counts = _counts()
        _reset()
        got = bsk.run_bootstrap(acc, cts)
        torch.cuda.synchronize()
        if call:
            assert _counts() == eager_counts
        assert torch.equal(got, want)
        assert torch.equal(bsk.run_bootstrap_many(acc, cts[:8], 1),
                           many(bsk.cfg, key, acc_t, cts_t[:8], 1))
    assert all(len(c.graphs) == 1 for c in bsk.evaluation.graphs.values())
    assert len(bsk.evaluation.graphs) == 2


def test_gloo_tp_pipeline_is_eager_by_construction(dev, tmp_path):
    """Two processes of one rank each sharing the card on gloo (CUDA
    tensors; as multihost.run(2, 1): a rank's LOCAL_RANK is 0, the card's
    index): the dp pipeline (no collective) is graphed, the tp=2 pipeline
    (an all_reduce each CMux step, through the host) runs eager; both bit
    for bit the unsharded call (checked by the ranks)."""
    cases = [("dp mxu 2x1", "u32 bl8", "dp mxu", 2, 1),
             ("mxu 1x2", "u32 bl8", "mxu", 1, 2)]
    multihost.spawn(dryrun.run_cases, 2, 1, (str(tmp_path), "cuda", cases),
                    backend="gloo", timeout=600)
    assert json.loads((tmp_path / "graphed.json").read_text()) == {
        "0": True, "1": False}
