"""The data-parallel gate front (parallel/serve.py) and the dry run's ranks
on the card: two gloo ranks sharing one card serve every gate at DEFAULT
bit for bit as the single-card ServerKey; NCCL ranks on every card present
(two or more) do the same; dryrun.run_group runs a world of two on one card
(each rank's device set before its mesh is built).

Marked `cuda`: these tests need an NVIDIA GPU and nvcc, and skip anywhere
else (the check runs inside a fixture, never at import). On a GPU machine:
    python -m pytest --noconftest tests/test_torch_parallel_serve_cuda.py"""

import json
import multiprocessing
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from concrete_tpu_torch import boolean
from concrete_tpu_torch.ops import _cuda
from concrete_tpu_torch.params import DEFAULT_PARAMETERS
from concrete_tpu_torch.parallel import dryrun, serve

pytestmark = pytest.mark.cuda

ROWS, TIER = 300, 256
METHODS = ["and_", "nand", "or_", "nor", "xor", "xnor"]


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
def keys(dev):
    cks, sks = boolean.gen_keys(DEFAULT_PARAMETERS, secret_seed=21,
                                mask_seed=22, noise_seed=23, device=dev)
    rng = np.random.default_rng(5)
    bits = [rng.integers(0, 2, ROWS).astype(bool) for _ in range(2)]
    cts = [cks.encrypt(b, mask_seed=30 + i, noise_seed=40 + i)
           for i, b in enumerate(bits)]
    return cks, sks, bits, cts


def check_front(front, keys):
    cks, sks, bits, (a, b) = keys
    front.warmup(batch_sizes=(TIER,), gates=("and",))
    for name in METHODS:
        got = getattr(front, name)(a, b)
        assert got.device == torch.device("cuda", 0)
        assert torch.equal(got, getattr(sks, name)(a, b)), name
    assert np.array_equal(cks.decrypt(front.and_(a, b)), bits[0] & bits[1])
    pids = front.pids
    front.close()
    assert not [p for p in multiprocessing.active_children()
                if p.pid in pids]


def test_two_gloo_ranks_on_one_card(dev, keys):
    check_front(serve.GateFront(keys[1], 2, backend="gloo"), keys)


def test_nccl_ranks_on_every_card(dev, keys):
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two cards or more")
    check_front(serve.GateFront(keys[1], cards), keys)


def test_dryrun_world_two_on_one_card(dev):
    cases = [("u32 dp ntt", "u32 bl8", "dp ntt", 2, 1),
             ("u32 tp=2 mxu", "u32 bl8", "mxu", 1, 2)]
    with tempfile.TemporaryDirectory() as out:
        dryrun.run_group(cases, out, device="cuda", backend="gloo",
                         timeout=600)
        assert json.loads((Path(out) / "graphed.json").read_text()) == {
            "0": True, "1": False}
