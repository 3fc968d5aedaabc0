"""The port's high-level API (concrete_tpu_torch.highlevel) held against
concrete_tpu.highlevel on the CPU. Keys made by the JAX package are saved
and loaded by the port (the way keys are carried across; the two packages
draw randomness from different streams), then both run the same operations
on the same ciphertext data: every torus value must be equal (tolerance 0),
encoder fields and tracked variances equal to a relative 1e-12. The JAX
bootstrapping key is pinned to its "mxu" backend, so both sides take the
same variance branch (the truncation term of fast mode). The port's own
keys must decode a 4-bit LUT, exact and in fast mode, and its entry points
must refuse to fall back to the CPU when no device is named."""

import dataclasses

import numpy as np
import pytest
import torch

from concrete_tpu import highlevel as hl_jax
from concrete_tpu_torch import highlevel as hl_t
from concrete_tpu_torch.ops import _cuda

# (N, k, base_log, level, precision): the int4 example's gadget at N=256 and
# a k=2 configuration at N=64
CONFIGS = [(256, 1, 7, 3, 4), (64, 2, 10, 3, 3)]
N_LWE = 16


def _jax_keys(n, k, bl, l):
    sk = hl_jax.LWESecretKey.new(hl_jax.LWEParams(N_LWE, -40), secret_seed=1)
    rsk = hl_jax.RLWESecretKey.new(hl_jax.RLWEParams(n, k, -50), secret_seed=2)
    bsk = hl_jax.LWEBSK.new(sk, rsk, bl, l, mask_seed=3, noise_seed=4)
    ksk = hl_jax.LWEKSK.new(rsk.to_lwe_secret_key(), sk, 2, 8, mask_seed=5,
                            noise_seed=6)
    return sk, rsk, dataclasses.replace(bsk, backend="mxu"), ksk


@pytest.fixture(scope="module", params=CONFIGS, ids=["N256_k1", "N64_k2"])
def keys(request, tmp_path_factory):
    """(jax keys, port keys loaded from the JAX package's files, precision)."""
    n, k, bl, l, prec = request.param
    jk = _jax_keys(n, k, bl, l)
    d = tmp_path_factory.mktemp("hl")
    names = ("sk.npz", "rsk.npz", "bsk.npz", "ksk.npz")
    for key, name in zip(jk, names):
        key.save(str(d / name))
    tk = (hl_t.LWESecretKey.load(str(d / names[0])),
          hl_t.RLWESecretKey.load(str(d / names[1])),
          hl_t.LWEBSK.load(str(d / names[2]), device="cpu"),
          hl_t.LWEKSK.load(str(d / names[3]), device="cpu"))
    return jk, tk, prec


def _encoder_t(e):
    return hl_t.Encoder(**dataclasses.asdict(e))


def _lwe_t(ct):
    return hl_t.LWE(ct.data.copy(), _encoder_t(ct.encoder), ct.variance)


def _vec_t(v):
    return hl_t.VectorLWE(v.data.copy(), [_encoder_t(e) for e in v.encoders],
                          v.variances.copy())


def _assert_encoder(got, want):
    assert (got.nb_bit_precision, got.nb_bit_padding, got.round) == \
        (want.nb_bit_precision, want.nb_bit_padding, want.round)
    np.testing.assert_allclose([got.o, got.delta], [want.o, want.delta],
                               rtol=1e-12, atol=0)


def _assert_lwe(got, want):
    assert got.data.dtype == np.uint64
    np.testing.assert_array_equal(got.data, want.data)
    _assert_encoder(got.encoder, want.encoder)
    np.testing.assert_allclose(got.variance, want.variance, rtol=1e-12, atol=0)


def _assert_vec(got, want):
    np.testing.assert_array_equal(got.data, want.data)
    assert len(got.encoders) == len(want.encoders)
    for g, w in zip(got.encoders, want.encoders):
        _assert_encoder(g, w)
    np.testing.assert_allclose(got.variances, want.variances, rtol=1e-12,
                               atol=0)


def _encoder(prec, lo=0.0, hi=None, pad=1):
    hi = float((1 << prec) - 1) if hi is None else hi
    return hl_jax.Encoder.new(lo, hi, nb_bit_precision=prec, nb_bit_padding=pad)


def _lut(x, prec):
    return float((3 * int(round(x)) + 1) % (1 << prec))


def test_keys_load_and_save_in_the_jax_format(keys, tmp_path):
    (jsk, jrsk, jbsk, jksk), (tsk, trsk, tbsk, tksk), _ = keys
    np.testing.assert_array_equal(tsk.inner.key, jsk.inner.key)
    np.testing.assert_array_equal(trsk.inner.key, jrsk.inner.key)
    np.testing.assert_array_equal(tbsk.coefficient_bsk, jbsk.coefficient_bsk)
    np.testing.assert_array_equal(tksk.inner.data, jksk.inner.data)
    assert (tsk.std_dev, trsk.std_dev, tbsk.variance, tksk.variance) == \
        (jsk.std_dev, jrsk.std_dev, jbsk.variance, jksk.variance)
    for f in ("lwe_dimension", "glwe_dimension", "polynomial_size",
              "pbs_base_log", "pbs_level", "bits", "mxu_limb_drop"):
        assert getattr(tbsk.cfg, f) == getattr(jbsk.cfg, f)
    assert tbsk.resolved_backend() == jbsk.resolved_backend() == "mxu"
    # the port's files load back into the JAX package
    tsk.save(str(tmp_path / "sk"))
    tbsk.save(str(tmp_path / "bsk"))
    tksk.save(str(tmp_path / "ksk"))
    np.testing.assert_array_equal(
        hl_jax.LWESecretKey.load(str(tmp_path / "sk.npz")).inner.key, jsk.inner.key)
    np.testing.assert_array_equal(
        hl_jax.LWEBSK.load(str(tmp_path / "bsk.npz")).coefficient_bsk,
        jbsk.coefficient_bsk)
    np.testing.assert_array_equal(
        hl_jax.LWEKSK.load(str(tmp_path / "ksk.npz")).inner.data, jksk.inner.data)


@pytest.mark.parametrize("drop", [0, 2])
def test_bootstrap_with_function_and_keyswitch_match_jax(keys, drop):
    (jsk, jrsk, jbsk, jksk), (tsk, trsk, tbsk, tksk), prec = keys
    if drop:
        jbsk, tbsk = jbsk.with_fast_mode(limb_drop=drop), tbsk.with_fast_mode(limb_drop=drop)
    enc = _encoder(prec)
    xs = np.arange(1 << prec, dtype=np.float64)
    ct = hl_jax.LWE.encode_encrypt(jsk, xs, enc, mask_seed=7, noise_seed=8)
    fn = lambda x: _lut(x, prec)                             # noqa: E731
    want = ct.bootstrap_with_function(jbsk, fn, enc)
    got = _lwe_t(ct).bootstrap_with_function(tbsk, fn, _encoder_t(enc))
    _assert_lwe(got, want)
    want_ks, got_ks = want.keyswitch(jksk), got.keyswitch(tksk)
    _assert_lwe(got_ks, want_ks)
    np.testing.assert_allclose(tbsk.bootstrap_output_variance(N_LWE),
                               jbsk.bootstrap_output_variance(N_LWE),
                               rtol=1e-12, atol=0)


def test_bootstrap_with_functions_and_mul_match_jax(keys):
    (jsk, _, jbsk, _), (_, _, tbsk, _), prec = keys
    enc = _encoder(prec)
    ct = hl_jax.LWE.encode_encrypt(jsk, np.arange(4, dtype=np.float64) + 1,
                                   enc, mask_seed=9, noise_seed=10)
    fns = [lambda x: x, lambda x: float((1 << prec) - 1) - x]
    want = ct.bootstrap_with_functions(jbsk, fns, enc)
    got = _lwe_t(ct).bootstrap_with_functions(tbsk, fns, _encoder_t(enc))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_lwe(g, w)
    e2 = _encoder(prec, -2.0, 2.0, pad=2)
    a = hl_jax.LWE.encode_encrypt(jsk, [1.0, -1.5], e2, mask_seed=11, noise_seed=12)
    b = hl_jax.LWE.encode_encrypt(jsk, [0.5, 1.0], e2, mask_seed=13, noise_seed=14)
    _assert_lwe(_lwe_t(a).mul_from_bootstrap(_lwe_t(b), tbsk),
                a.mul_from_bootstrap(b, jbsk))


def test_padding_and_constant_ops_match_jax(keys):
    (jsk, _, _, _), _, prec = keys
    enc = _encoder(prec, -4.0, 4.0, pad=3)
    a = hl_jax.LWE.encode_encrypt(jsk, [1.0, -2.5, 3.0], enc, mask_seed=15,
                                  noise_seed=16)
    b = hl_jax.LWE.encode_encrypt(jsk, [0.5, 1.0, -3.5], enc, mask_seed=17,
                                  noise_seed=18)
    ta, tb = _lwe_t(a), _lwe_t(b)
    for op in ("add_with_padding", "sub_with_padding", "add_with_padding_exact",
               "sub_with_padding_exact", "add_centered"):
        _assert_lwe(getattr(ta, op)(tb), getattr(a, op)(b))
    _assert_lwe(ta.add_with_new_min(tb, -8.0), a.add_with_new_min(b, -8.0))
    _assert_lwe(ta.remove_padding(2), a.remove_padding(2))
    _assert_lwe(ta.opposite(), a.opposite())
    _assert_lwe(ta.add_constant_static_encoder([0.5, 1.0, -1.0]),
                a.add_constant_static_encoder([0.5, 1.0, -1.0]))
    _assert_lwe(ta.add_constant_dynamic_encoder(2.0),
                a.add_constant_dynamic_encoder(2.0))
    _assert_lwe(ta.mul_constant_static_encoder([2, -1, 3]),
                a.mul_constant_static_encoder([2, -1, 3]))
    _assert_lwe(ta.mul_constant_with_padding(-1.5, 2.0, 2),
                a.mul_constant_with_padding(-1.5, 2.0, 2))
    with pytest.raises(hl_t.NotEnoughPaddingError):
        ta.remove_padding(4)


def test_vector_lwe_matches_jax(keys):
    (jsk, _, jbsk, jksk), (tsk, _, tbsk, tksk), prec = keys
    enc = _encoder(prec)
    xs = np.arange(1 << prec, dtype=np.float64)[::-1].copy()
    v = hl_jax.VectorLWE.encode_encrypt(jsk, xs, enc, mask_seed=19, noise_seed=20)
    tv = _vec_t(v)
    fn = lambda x: _lut(x, prec)                             # noqa: E731
    want = v.bootstrap_all_with_function(jbsk, fn, enc)
    got = tv.bootstrap_all_with_function(tbsk, fn, _encoder_t(enc))
    _assert_vec(got, want)
    _assert_vec(got.keyswitch(tksk), want.keyswitch(jksk))
    _assert_vec(tv.bootstrap_nth_with_function(tbsk, fn, _encoder_t(enc), 3),
                v.bootstrap_nth_with_function(jbsk, fn, enc, 3))
    w = hl_jax.VectorLWE.encode_encrypt(jsk, xs, _encoder(prec, pad=5),
                                        mask_seed=21, noise_seed=22)
    tw = _vec_t(w)
    _assert_vec(tw.add_with_padding(tw), w.add_with_padding(w))
    _assert_vec(tw.sub_with_padding(tw), w.sub_with_padding(w))
    _assert_lwe(tw.sum_with_padding(), w.sum_with_padding())
    consts = np.resize([-1.0, 0.5, 0.75, -0.25], xs.size)
    _assert_vec(tw.mul_constant_with_padding(consts, 1.0, 2),
                w.mul_constant_with_padding(consts, 1.0, 2))
    np.testing.assert_array_equal(tv.decrypt_decode(tsk), v.decrypt_decode(jsk))


def test_encoder_and_plaintext_match_jax():
    msgs = np.linspace(-10.0, 10.0, 37)
    for args in ((-10.0, 10.0, 8, 2), (-10.0, 10.0, 5, 0), (0.0, 1.0, 3, 1)):
        je, te = hl_jax.Encoder.new(*args), hl_t.Encoder.new(*args)
        _assert_encoder(te, je)
        m = np.clip(msgs, args[0], args[1])
        pts = te.encode_core(m)
        np.testing.assert_array_equal(pts, je.encode_core(m))
        np.testing.assert_array_equal(te.decode_core(pts), je.decode_core(pts))
        for var in (2.0 ** -60, 2.0 ** -20):
            a, b = te.copy(), je.copy()
            assert a.update_precision_from_variance(var) == \
                b.update_precision_from_variance(var)
            _assert_encoder(a, b)
    je = hl_jax.Encoder.new_rounding_context(0.0, 15.0, 4, 1)
    te = hl_t.Encoder.new_rounding_context(0.0, 15.0, 4, 1)
    pts = te.encode_core(np.arange(16.0))
    np.testing.assert_array_equal(pts, je.encode_core(np.arange(16.0)))
    np.testing.assert_array_equal(te.decode_core(pts + np.uint64(12345)),
                                  je.decode_core(pts + np.uint64(12345)))
    _assert_encoder(te.opposite(), je.opposite())
    _assert_encoder(te.new_square_divided_by_four(2),
                    je.new_square_divided_by_four(2))
    tp = hl_t.Plaintext.encode([1.0, 4.0], te)
    jp = hl_jax.Plaintext.encode([1.0, 4.0], je)
    np.testing.assert_array_equal(tp.plaintexts, jp.plaintexts)
    np.testing.assert_array_equal(tp.decode(), jp.decode())


@pytest.mark.parametrize("drop", [0, 2])
def test_port_keys_decode_a_4bit_lut(drop):
    """The int4 example at a small size, on keys the port made itself."""
    sk = hl_t.LWESecretKey.new(hl_t.LWEParams(N_LWE, -40), secret_seed=1)
    rsk = hl_t.RLWESecretKey.new(hl_t.RLWEParams(256, 1, -50), secret_seed=2)
    bsk = hl_t.LWEBSK.new(sk, rsk, 7, 3, mask_seed=3, noise_seed=4, device="cpu")
    ksk = hl_t.LWEKSK.new(rsk.to_lwe_secret_key(), sk, 2, 8, mask_seed=5,
                          noise_seed=6, device="cpu")
    if drop:
        bsk = bsk.with_fast_mode(limb_drop=drop)
    enc = hl_t.Encoder.new(0.0, 15.0, nb_bit_precision=4, nb_bit_padding=1)
    xs = np.arange(16, dtype=np.float64)
    v = hl_t.VectorLWE.encode_encrypt(sk, xs, enc, mask_seed=7, noise_seed=8)
    out = v.bootstrap_all_with_function(bsk, lambda x: _lut(x, 4), enc)
    big = np.round(out.decrypt_decode(rsk.to_lwe_secret_key()))
    np.testing.assert_array_equal(big, [(3 * x + 1) % 16 for x in range(16)])
    small = np.round(out.keyswitch(ksk).decrypt_decode(sk))
    np.testing.assert_array_equal(small, [(3 * x + 1) % 16 for x in range(16)])


def test_entry_points_refuse_a_silent_cpu_fallback(monkeypatch):
    """Without CUDA, a key with no device raises and names device="cpu"."""
    from concrete_tpu_torch import boolean
    from concrete_tpu_torch.core import bootstrap as bs
    from concrete_tpu_torch.dispersion import StandardDev
    from concrete_tpu_torch.params import BooleanParameters

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _cuda.resolve_device()
    tiny = BooleanParameters(4, 1, 16, StandardDev(0.0), StandardDev(0.0),
                             7, 2, 2, 2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        boolean.gen_keys(tiny, secret_seed=1, mask_seed=2, noise_seed=3)
    cks, sks = boolean.gen_keys(tiny, secret_seed=1, mask_seed=2, noise_seed=3,
                                device="cpu")
    assert sks.device.type == "cpu"
    with pytest.raises(RuntimeError):
        boolean.ServerKey(ksk=sks.ksk, cfg=sks.cfg, bsk_standard=sks.bsk_standard)
    cfg = bs.ServerConfig(4, 1, 16, 7, 2, 1, 1, bits=64)
    with pytest.raises(RuntimeError):
        hl_t.LWEBSK(cfg=cfg, variance=0.0,
                    coefficient_bsk=np.zeros((4, 2, 2, 2, 16), np.uint64))
    sk = hl_t.LWESecretKey.new(hl_t.LWEParams(8, -40), secret_seed=1)
    with pytest.raises(RuntimeError):
        hl_t.LWEKSK.new(sk, sk, 2, 4, mask_seed=1, noise_seed=2)
    assert hl_t.LWEKSK.new(sk, sk, 2, 4, mask_seed=1, noise_seed=2,
                           device="cpu").device == torch.device("cpu")
