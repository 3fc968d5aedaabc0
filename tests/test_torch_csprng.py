"""The port's AES-CTR CSPRNG against concrete_tpu.csprng, byte for byte
(tolerance 0): the AES (native library and numpy), the generator's states,
forks and bounds, every distribution with the generator's state after each
call, the batched Gaussian sweep, the encryption generator's fork budgets,
the byte-streaming __main__, and test_golden.py's stream digests."""

import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from concrete_tpu.csprng import aes as aes_jax
from concrete_tpu.csprng import encryption as enc_jax
from concrete_tpu.csprng import generator as gen_jax
from concrete_tpu.csprng import random as rand_jax
from concrete_tpu_torch import native
from concrete_tpu_torch.csprng import aes
from concrete_tpu_torch.csprng import encryption as enc_t
from concrete_tpu_torch.csprng import generator as gen_t
from concrete_tpu_torch.csprng import random as rand_t

ROOT = Path(__file__).resolve().parents[1]
KEY = bytes(range(16))


def _h(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("native_aes", [True, False], ids=["native", "numpy"])
def test_aes_matches_jax(native_aes):
    rks = aes.key_schedule(KEY)
    np.testing.assert_array_equal(rks, aes_jax.key_schedule(KEY))
    blocks = np.random.default_rng(1).integers(0, 256, (37, 16), dtype=np.uint8)
    np.testing.assert_array_equal(
        aes.encrypt_blocks(blocks, rks, native=native_aes),
        aes_jax._encrypt_blocks_numpy(blocks, rks))
    # counters that carry across the low 64-bit word
    first = (5 << 64) + (1 << 64) - 3
    want = aes_jax._encrypt_blocks_numpy(np.stack([
        np.frombuffer(((first + i) % (1 << 128)).to_bytes(16, "little"), np.uint8)
        for i in range(7)]), rks).reshape(-1)
    np.testing.assert_array_equal(aes.ctr_fill(rks, first, 7, native=native_aes),
                                  want)
    lo = np.array([2 ** 64 - 2, 0, 17], dtype=np.uint64)
    hi = np.array([0, 3, 2 ** 64 - 1], dtype=np.uint64)
    np.testing.assert_array_equal(
        aes.ctr_fill_batch(rks, lo, hi, 5, native=native_aes),
        aes_jax.ctr_fill_batch(rks, lo, hi, 5))


def test_numpy_aes_runs_only_on_request():
    """The streams never take the numpy AES unless asked for it, and its
    calls are counted."""
    before = aes.NUMPY_CALLS
    g = rand_t.RandomGenerator(seed=3)
    g.generate_bytes(4096)
    rand_t.batch_fill_gaussian_torus(g.try_fork(3, 4096), 8, 2.0 ** -10, 32)
    assert aes.NUMPY_CALLS == before
    aes.ctr_fill(aes.key_schedule(KEY), 0, 2, native=False)
    assert aes.NUMPY_CALLS == before + 1
    assert native.has_aesni() in (True, False)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed build raises with the compiler's output; nothing falls back."""
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="native AES build failed"):
        native._build(tmp_path / "aes.so")
    assert not list(tmp_path.iterdir())


def test_generator_states_forks_and_bounds_match_jax():
    gj, gt = gen_jax.AesCtrGenerator(key=99), gen_t.AesCtrGenerator(key=99)
    for n in (0, 1, 5, 16, 127, 300):
        np.testing.assert_array_equal(gt.generate_bytes(n), gj.generate_bytes(n))
        assert gt.state.gpos == gj.state.gpos
    assert gt.generate_next() == gj.generate_next()
    kids_j, kids_t = gj.try_fork(3, 40), gt.try_fork(3, 40)
    assert gt.state.gpos == gj.state.gpos
    for kj, kt in zip(kids_j, kids_t):
        assert kt.remaining_bytes() == kj.remaining_bytes() == 40
        grand_j, grand_t = kj.try_fork(2, 8), kt.try_fork(2, 8)
        for a, b in zip(grand_j, grand_t):
            np.testing.assert_array_equal(b.generate_bytes(8), a.generate_bytes(8))
        np.testing.assert_array_equal(kt.generate_bytes(24), kj.generate_bytes(24))
        with pytest.raises(RuntimeError):
            kt.generate_bytes(1)
        with pytest.raises(RuntimeError):
            kt.try_fork(1, 1)
    s = gen_t.State(aes_ctr=(1 << 128) - 1, byte_ctr=20)
    assert (s.aes_ctr, s.byte_ctr) == (0, 4)          # wraps mod 2^132
    assert s.shifted(16 * 3).gpos == gen_jax.State(
        aes_ctr=(1 << 128) - 1, byte_ctr=20).shifted(48).gpos
    with pytest.raises(ValueError):
        gen_t.State(0, 128)
    with pytest.raises(ValueError):
        gen_t.AesCtrGenerator(key=1, state=gen_t.State(0, 5),
                              bound=gen_t.State(0, 4))


DRAWS = {
    "uniform": lambda g, b: g.random_uniform_array(37, b),
    "binary": lambda g, b: g.random_uniform_binary_array(37, b),
    "ternary": lambda g, b: g.random_uniform_ternary_array(99, b),
    "n_lsb": lambda g, b: g.random_uniform_n_lsb_array(9, 5, b),
    "n_msb": lambda g, b: g.random_uniform_n_msb_array(9, 5, b),
    "with_zeros": lambda g, b: g.random_uniform_with_zeros_array(301, 0.3, b),
    "gaussian_pairs": lambda g, b: np.stack(g.random_gaussian_pairs(41, 0.5, 2.0 ** -9)),
    "gaussian_torus": lambda g, b: g.fill_gaussian_torus(57, 2.0 ** -12, b),
    "gaussian_float": lambda g, b: g.fill_gaussian_float(57, 1.0, 3.0),
}


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("kind", sorted(DRAWS))
def test_distributions_and_states_match_jax(kind, bits):
    """Each draw, three times in a row from one generator, equal to
    concrete_tpu's with the same stream position after each call (a
    rewind off by one byte shows only in the next draw)."""
    gj, gt = rand_jax.RandomGenerator(seed=7), rand_t.RandomGenerator(seed=7)
    for _ in range(3):
        got, want = DRAWS[kind](gt, bits), DRAWS[kind](gj, bits)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert gt.inner.state.gpos == gj.inner.state.gpos


def test_uniform_with_zeros_matches_its_sequential_oracle():
    for prob in (0.0, 0.5, 0.97):
        a, b = rand_t.RandomGenerator(seed=3), rand_t.RandomGenerator(seed=3)
        np.testing.assert_array_equal(
            a.random_uniform_with_zeros_array(200, prob, 64),
            b._random_uniform_with_zeros_sequential(200, prob, 64))
        assert a.inner.state.gpos == b.inner.state.gpos
    child = rand_t.RandomGenerator(seed=4).try_fork(1, 20)[0]
    with pytest.raises(RuntimeError):
        child.random_uniform_with_zeros_array(10, 0.0, 32)


@pytest.mark.parametrize("bits", [32, 64])
def test_batch_gaussian_matches_the_loop_and_jax(bits):
    """batch_fill_gaussian_torus equals the per-generator loop and
    concrete_tpu's batch, values and final states, with children that start
    mid-block; a child too small for one attempt raises."""
    gens = []
    for mod in (rand_t, rand_t, rand_jax):
        parent = mod.RandomGenerator(seed=9)
        parent.generate_bytes(3)
        gens.append(parent.try_fork(12, 15 * 256))
    loop = np.stack([g.fill_gaussian_torus(15, 2.0 ** -8, bits) for g in gens[0]])
    batch = rand_t.batch_fill_gaussian_torus(gens[1], 15, 2.0 ** -8, bits)
    want = rand_jax.batch_fill_gaussian_torus(gens[2], 15, 2.0 ** -8, bits)
    np.testing.assert_array_equal(batch, loop)
    np.testing.assert_array_equal(batch, want)
    for a, b, c in zip(*gens):
        assert a.inner.state.gpos == b.inner.state.gpos == c.inner.state.gpos
    with pytest.raises(RuntimeError):
        rand_t.batch_fill_gaussian_torus(
            rand_t.RandomGenerator(seed=6).try_fork(2, 8), 4, 2.0 ** -8, bits)


def test_batch_gaussian_straggler_rows_match_the_loop(monkeypatch):
    """Rows whose first window yields too few accepted attempts go on in
    the per-generator loop with the same bytes (forced with a stricter
    acceptance, patched into both paths)."""
    orig = rand_t._gaussian_attempt_eval

    def strict(raw):
        accept, uv = orig(raw)
        return accept & (uv[:, 0] ** 2 + uv[:, 1] ** 2 < 0.25), uv

    monkeypatch.setattr(rand_t, "_gaussian_attempt_eval", strict)
    ga = rand_t.RandomGenerator(seed=31).try_fork(6, 64 * 1024)
    gb = rand_t.RandomGenerator(seed=31).try_fork(6, 64 * 1024)
    want = np.stack([g.fill_gaussian_torus(64, 2.0 ** -8, 32) for g in ga])
    np.testing.assert_array_equal(
        rand_t.batch_fill_gaussian_torus(gb, 64, 2.0 ** -8, 32), want)
    for a, b in zip(ga, gb):
        assert a.inner.state.gpos == b.inner.state.gpos


def test_encryption_generators_and_budgets_match_jax():
    for name in ("mask_bytes_per_coef", "noise_bytes_per_coef",
                 "noise_bytes_per_lwe"):
        assert getattr(enc_t, name)(*(() if "noise" in name else (64,))) == \
            getattr(enc_jax, name)(*(() if "noise" in name else (64,)))
    assert enc_t.mask_bytes_per_ggsw(32, 3, 2, 16) == enc_jax.mask_bytes_per_ggsw(32, 3, 2, 16)
    assert enc_t.noise_bytes_per_ggsw(3, 2, 16) == enc_jax.noise_bytes_per_ggsw(3, 2, 16)
    assert enc_t.mask_bytes_per_gsw_level(64, 9) == enc_jax.mask_bytes_per_gsw_level(64, 9)
    gj, gt = enc_jax.EncryptionRandomGenerator(2, 3), enc_t.EncryptionRandomGenerator(2, 3)
    kids = zip(gj.fork_bsk_to_ggsw(32, 2, 2, 2, 16), gt.fork_bsk_to_ggsw(32, 2, 2, 2, 16))
    for kj, kt in kids:
        for lj, lt in zip(kj.fork_ggsw_to_ggsw_levels(32, 2, 2, 16),
                          kt.fork_ggsw_to_ggsw_levels(32, 2, 2, 16)):
            for rj, rt in zip(lj.fork_ggsw_level_to_glwe(32, 2, 16),
                              lt.fork_ggsw_level_to_glwe(32, 2, 16)):
                np.testing.assert_array_equal(rt.fill_noise(16, 2.0 ** -20, 32),
                                              rj.fill_noise(16, 2.0 ** -20, 32))
                np.testing.assert_array_equal(rt.fill_mask(16, 32), rj.fill_mask(16, 32))
                assert rt.remaining_bytes() == rj.remaining_bytes() == 0
    for lj, lt in zip(gj.fork_gsw_to_gsw_levels(64, 2, 5), gt.fork_gsw_to_gsw_levels(64, 2, 5)):
        for rj, rt in zip(lj.fork_gsw_level_to_lwe(64, 5), lt.fork_gsw_level_to_lwe(64, 5)):
            assert rt.random_noise(2.0 ** -30, 64) == rj.random_noise(2.0 ** -30, 64)
            np.testing.assert_array_equal(rt.fill_mask(4, 64), rj.fill_mask(4, 64))
    assert gt.mask.inner.state.gpos == gj.mask.inner.state.gpos
    assert gt.noise.inner.state.gpos == gj.noise.inner.state.gpos


@pytest.mark.parametrize("bits", [32, 64])
def test_secret_generator_kinds_match_jax(bits):
    sj, st = enc_jax.SecretRandomGenerator(5), enc_t.SecretRandomGenerator(5)
    for kind in ("binary", "ternary", "gaussian", "uniform"):
        np.testing.assert_array_equal(
            getattr(st, f"generate_{kind}_array")(33, bits),
            getattr(sj, f"generate_{kind}_array")(33, bits))
        assert st.inner.state.gpos == sj.inner.state.gpos


def test_main_streams_the_generator_bytes():
    out = subprocess.run(
        [sys.executable, "-m", "concrete_tpu_torch.csprng", "70000", "--seed=5"],
        cwd=ROOT, capture_output=True, timeout=120, check=True).stdout
    assert out == gen_jax.AesCtrGenerator(key=5).generate_bytes(70000).tobytes()


def test_golden_stream_digests():
    """tests/test_golden.py's CSPRNG pins, reproduced by the port."""
    g = gen_t.AesCtrGenerator(key=123456789)
    stream = g.generate_bytes(4096)
    forked = np.concatenate([c.generate_bytes(64) for c in g.try_fork(4, 64)])
    assert _h(stream) == "5b0835785adbf7f5"
    assert _h(forked) == "b98fe617bd7d6418"
