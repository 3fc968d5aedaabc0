"""The port's choice of backend and its gate warmup, on the CPU, held
against concrete_tpu: `auto` picks the exact-NTT backend on the u32 torus
wherever its primes take the configuration (concrete_tpu's rule off the
TPU) and keeps mxu / nuss on the u64 torus; `ServerKey.warmup` takes and
returns what concrete_tpu's does."""

import dataclasses

import numpy as np
import pytest

from concrete_tpu import boolean as boolean_jax
from concrete_tpu.core import bootstrap as bs_jax
from concrete_tpu_torch import boolean as boolean_t
from concrete_tpu_torch import highlevel as hl_t
from concrete_tpu_torch.core import backends as backends_t
from concrete_tpu_torch.core import bootstrap as bs_t
from concrete_tpu_torch.core import bootstrap_mxu as bsx_t
from concrete_tpu_torch.dispersion import StandardDev
from concrete_tpu_torch.params import BooleanParameters

from common import TINY

SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k, base_log, level", [(1, 7, 2), (1, 10, 3),
                                                (4, 7, 2), (1, 2, 3)])
def test_auto_u32_matches_jax_off_tpu(n, k, base_log, level):
    """u32: the port picks ntt exactly where concrete_tpu, off the TPU, does
    (every configuration its ServerConfig takes)."""
    args = (16, k, n, base_log, level, 2, 5)
    sks_j = boolean_jax.ServerKey(ksk=None, cfg=bs_jax.ServerConfig(*args),
                                  bsk_standard=None)
    cfg = bs_t.ServerConfig(*args)
    assert sks_j.resolved_backend() == "ntt"
    assert backends_t.resolve_backend(cfg, "auto") == "ntt"
    assert cfg.primes == sks_j.cfg.primes


@pytest.mark.parametrize("n", SIZES)
def test_auto_u64_keeps_toeplitz_paths(n):
    """u64: mxu up to N = 4096, nuss above, though the ntt backend takes
    every one of these configurations."""
    cfg = bs_t.ServerConfig(16, 1, n, 7, 3, 2, 5, bits=64)
    assert cfg.primes
    want = "mxu" if n <= 4096 else "nuss"
    assert backends_t.resolve_backend(cfg, "auto") == want
    bsk = hl_t.LWEBSK(hl_t.LWEBSK._config(16, 1, n, 7, 3), 0.0,
                      np.zeros((16, 3, 2, 2, n), np.uint64), device="cpu")
    assert bsk.resolved_backend() == want


@pytest.mark.parametrize("n, want", [(1024, "mxu"), (8192, "nuss")])
def test_auto_u32_without_primes_keeps_toeplitz_order(monkeypatch, n, want):
    """u32 where the ntt backend refuses the configuration (its primes
    raise): mxu up to N = 4096, nuss above, as before."""
    def refuse(self):
        raise NotImplementedError("no CRT primes")

    monkeypatch.setattr(bs_t.ServerConfig, "primes", property(refuse))
    cfg = bs_t.ServerConfig(16, 1, n, 7, 2, 2, 5)
    assert backends_t.resolve_backend(cfg, "auto") == want


def test_mxu_refusal_names_the_large_n_backends():
    cfg = bs_t.ServerConfig(16, 1, 8192, 7, 2, 2, 5)
    with pytest.raises(NotImplementedError, match='backend="nuss"'):
        bsx_t.MxuPlan.from_config(cfg)


def _tiny_port_params():
    return BooleanParameters(
        TINY.lwe_dimension, TINY.glwe_dimension, TINY.polynomial_size,
        StandardDev(TINY.lwe_modular_std_dev.std_dev),
        StandardDev(TINY.glwe_modular_std_dev.std_dev), TINY.pbs_base_log,
        TINY.pbs_level, TINY.ks_base_log, TINY.ks_level)


@pytest.fixture(scope="module")
def tiny_pair():
    _, sks_j = boolean_jax.gen_keys(TINY, secret_seed=1, mask_seed=2,
                                    noise_seed=3)
    _, sks_t = boolean_t.gen_keys(_tiny_port_params(), secret_seed=1,
                                  mask_seed=2, noise_seed=3, device="cpu")
    return sks_j, sks_t


@pytest.mark.parametrize("kwargs", [
    {}, {"batch_sizes": (3, 16)}, {"batch_sizes": (4,), "gates": ("and", "xor")},
    {"batch_sizes": (2,), "gates": ("nand",), "mux": True}],
    ids=["default-args", "two-tiers", "two-gates", "mux"])
def test_warmup_keys_match_jax(tiny_pair, kwargs):
    """warmup's arguments and the keys it returns, {(gate, tier): s}, as
    concrete_tpu's; both key sets warm the same tiers. The default batch
    size, 2048, is replaced by a small one on both sides."""
    sks_j, sks_t = (dataclasses.replace(s, _warmed_tiers=set())
                    for s in tiny_pair)
    kwargs = {"batch_sizes": (8,), **kwargs}
    got, want = sks_t.warmup(**kwargs), sks_j.warmup(**kwargs)
    assert set(got) == set(want)
    assert all(s >= 0 for s in got.values())
    assert sks_t._warmed_tiers == sks_j._warmed_tiers


def test_warmup_runs_the_serving_example_call(tiny_pair):
    """examples/serving.py's call runs on a port key, and every request up
    to the tier pads to it."""
    sks = dataclasses.replace(tiny_pair[1], _warmed_tiers=set())
    t = sks.warmup(batch_sizes=(64,), gates=("and", "xor"))
    assert set(t) == {("and", 64), ("xor", 64)}
    assert sks._pad_size(17) == 64
    with pytest.raises(ValueError):
        sks.warmup(batch_sizes=(4,), gates=("and_",))
