"""The port's VectorRLWE and the encoder's struct-of-arrays helpers held
against concrete_tpu on the CPU: twins of the VectorRLWE cases of
tests/test_highlevel.py and tests/test_highlevel_ops.py run through both
packages on one RLWE key (made by concrete_tpu, carried across by
save / load) with the same seeds. Ciphertexts must be equal bit for bit,
encoder fields and variances to a relative 1e-12, and the same inputs must
raise the same errors."""

import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest

import concrete_tpu.highlevel as hl_jax
import concrete_tpu.highlevel.encoder as enc_jax
import concrete_tpu_torch.highlevel as hl_t
import concrete_tpu_torch.highlevel.encoder as enc_t
from concrete_tpu.highlevel import errors as err_jax
from concrete_tpu_torch.highlevel import errors as err_t

GOLDEN = Path(__file__).resolve().parent / "golden_serde"
RLWE_PARAMS = hl_jax.RLWEParams(polynomial_size=128, dimension=1,
                                log2_std_dev=-45)
REL = 1e-12


@pytest.fixture(scope="module")
def pkgs(tmp_path_factory):
    """Both packages' API beside the same RLWE key (seed 2, as the JAX
    tests' module fixture), the port's loaded from the JAX key's npz."""
    sk_jax = hl_jax.RLWESecretKey.new(RLWE_PARAMS, secret_seed=2)
    path = str(tmp_path_factory.mktemp("rlwe") / "rsk.npz")
    sk_jax.save(path)
    sk_t = hl_t.RLWESecretKey.load(path)
    np.testing.assert_array_equal(sk_t.inner.key, sk_jax.inner.key)
    return [types.SimpleNamespace(hl=hl_jax, errors=err_jax, sk=sk_jax),
            types.SimpleNamespace(hl=hl_t, errors=err_t, sk=sk_t)]


def _close(a, b, what):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    np.testing.assert_allclose(a, b, rtol=REL, atol=0, err_msg=what)


def _fields(enc):
    return (enc.o, enc.delta, enc.nb_bit_precision, enc.nb_bit_padding,
            enc.round)


def _same_encoders(ea, eb, what):
    assert len(ea) == len(eb), what
    fa = np.array([_fields(e)[:2] for e in ea])
    fb = np.array([_fields(e)[:2] for e in eb])
    _close(fa, fb, what)
    assert [_fields(e)[2:] for e in ea] == [_fields(e)[2:] for e in eb], what


def _same(a, b, what="result"):
    """Port result `b` against JAX result `a`, recursively."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif hasattr(a, "encoders") and hasattr(a, "data"):
        np.testing.assert_array_equal(b.data, a.data, err_msg=what)
        _close(a.variances, b.variances, what + ".variances")
        _same_encoders(a.encoders, b.encoders, what + ".encoders")
    elif hasattr(a, "nb_bit_padding"):
        _same_encoders([a], [b], what)
    elif isinstance(a, np.ndarray) and a.dtype.kind == "f":
        _close(a, b, what)
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=what)


def _twin(pkgs, scenario):
    """Run scenario(ns) on both packages; an exception is a result too
    (its class name), so both must raise the same error."""
    outs = []
    for ns in pkgs:
        try:
            outs.append(scenario(ns))
        except Exception as e:  # noqa: BLE001 - compared across packages
            outs.append(("raises", type(e).__name__))
    _same(outs[0], outs[1])
    return outs[1]


def test_pack_extract(pkgs):
    def scenario(ns):
        enc = ns.hl.Encoder.new(0.0, 16.0, 6, 1)
        msgs = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
        v = ns.hl.VectorRLWE.encode_encrypt_packed(ns.sk, msgs, enc,
                                                   mask_seed=61, noise_seed=62)
        lwe = v.extract_1_lwe(2, 0)
        big = ns.sk.to_lwe_secret_key()
        return [v, v.nb_valid(), v.decrypt_decode(ns.sk), lwe,
                lwe.decrypt_decode(big)]

    out = _twin(pkgs, scenario)
    assert out[1] == 5
    assert abs(out[4][0] - 3.0) < hl_t.Encoder.new(0.0, 16.0, 6, 1).get_granularity()


def test_extract_bunch_every_coefficient(pkgs):
    """The port's one-gather extraction gives concrete_tpu's per-coefficient
    loop's bits, on every coefficient of every ciphertext."""
    def scenario(ns):
        enc = ns.hl.Encoder.new(0.0, 16.0, 5, 1)
        msgs = np.arange(300) % 16
        v = ns.hl.VectorRLWE.encode_encrypt_packed(ns.sk, msgs, enc,
                                                   mask_seed=3, noise_seed=4)
        n = v.polynomial_size
        outs = [v.extract_bunch_of_lwes(range(n), i)
                for i in range(v.nb_ciphertexts)]
        return outs + [v.extract_bunch_of_lwes([5, 0, n - 1, 5], 1)]

    _twin(pkgs, scenario)


@pytest.mark.parametrize("bad", [(128, 0), (0, 3)], ids=["coeff", "ciphertext"])
def test_extract_out_of_range_raises(pkgs, bad):
    def scenario(ns):
        v = ns.hl.VectorRLWE.zero(128, 1, 2)
        return v.extract_1_lwe(*bad)

    assert _twin(pkgs, scenario)[0] == "raises"


def test_encrypt_nonpacked(pkgs):
    def scenario(ns):
        enc = ns.hl.Encoder.new(0.0, 16.0, 6, 1)
        v = ns.hl.VectorRLWE.encode_encrypt(ns.sk, [3.0, 12.0], enc,
                                            mask_seed=50, noise_seed=51)
        return [v, v.nb_ciphertexts, v.nb_valid(), v.decrypt_decode(ns.sk),
                v.decrypt_decode_round(ns.sk)]

    _twin(pkgs, scenario)


def test_encrypt_plaintext_nonpacked(pkgs):
    def scenario(ns):
        enc = ns.hl.Encoder.new(0.0, 16.0, 6, 1)
        p = ns.hl.Plaintext.encode([5.0, 9.0], enc)
        v = ns.hl.VectorRLWE.encrypt(ns.sk, p, mask_seed=52, noise_seed=53)
        msgs, encs = v.decrypt_with_encoders(ns.sk)
        packed = ns.hl.VectorRLWE.encrypt_packed(ns.sk, p, mask_seed=54,
                                                 noise_seed=55)
        return [v, msgs, encs, packed]

    _twin(pkgs, scenario)


def test_encrypt_packed_raw(pkgs):
    def scenario(ns):
        n = ns.sk.polynomial_size
        v = ns.hl.VectorRLWE.zero(n, ns.sk.dimension, 1)
        pts = np.arange(n, dtype=np.uint64) << np.uint64(50)
        v.encrypt_packed_raw(ns.sk, pts, mask_seed=54, noise_seed=55)
        return [v, v.nb_valid()]

    _twin(pkgs, scenario)

    def short(ns):
        v = ns.hl.VectorRLWE.zero(128, 1, 1)
        v.encrypt_packed_raw(ns.sk, np.zeros(65, np.uint64))

    assert _twin(pkgs, short) == ("raises", "DimensionError")


@pytest.mark.parametrize("op", ["add_with_padding", "sub_with_padding",
                                "add_centered"])
def test_pairwise_ops(pkgs, op):
    def scenario(ns):
        if op == "add_centered":
            enc = ns.hl.Encoder.new_centered(0.0, 8.0, 6, 1)
            xs, ys = [3.0, -2.0], [1.0, -4.0]
        else:
            enc = ns.hl.Encoder.new(0.0, 16.0, 6, 1)
            xs, ys = [9.0, 12.0], [4.0, 2.0]
        a = ns.hl.VectorRLWE.encode_encrypt_packed(ns.sk, xs, enc,
                                                   mask_seed=56, noise_seed=57)
        b = ns.hl.VectorRLWE.encode_encrypt_packed(ns.sk, ys, enc,
                                                   mask_seed=58, noise_seed=59)
        out = getattr(a, op)(b)
        return [out, out.decrypt_decode(ns.sk)]

    _twin(pkgs, scenario)


def test_pairwise_errors(pkgs):
    def no_padding(ns):
        enc = ns.hl.Encoder.new(0.0, 16.0, 6, 0)
        a = ns.hl.VectorRLWE.encode_encrypt_packed(ns.sk, [1.0], enc,
                                                   mask_seed=1, noise_seed=2)
        return a.add_with_padding(a)

    def other_delta(ns):
        a = ns.hl.VectorRLWE.encode_encrypt_packed(
            ns.sk, [1.0], ns.hl.Encoder.new(0.0, 16.0, 6, 1), mask_seed=1,
            noise_seed=2)
        b = ns.hl.VectorRLWE.encode_encrypt_packed(
            ns.sk, [1.0], ns.hl.Encoder.new(0.0, 32.0, 6, 1), mask_seed=3,
            noise_seed=4)
        return a.add_centered(b)

    assert _twin(pkgs, no_padding) == ("raises", "NotEnoughPaddingError")
    assert _twin(pkgs, other_delta) == ("raises", "DeltaError")


def test_mul_constant_with_padding(pkgs):
    def scenario(ns):
        enc = ns.hl.Encoder.new(-2.0, 2.0, 5, 3)
        a = ns.hl.VectorRLWE.encode_encrypt_packed(ns.sk, [1.0, -0.5], enc,
                                                   mask_seed=68, noise_seed=69)
        out = a.mul_constant_with_padding([2.0], 4.0, 2)
        out2 = a.mul_constant_with_padding([-2.0], 4.0, 2)
        return [out, out.decrypt_decode(ns.sk), out2,
                out2.decrypt_decode(ns.sk)]

    _twin(pkgs, scenario)

    def too_big(ns):
        enc = ns.hl.Encoder.new(-2.0, 2.0, 5, 3)
        a = ns.hl.VectorRLWE.encode_encrypt_packed(ns.sk, [1.0], enc,
                                                   mask_seed=1, noise_seed=2)
        return a.mul_constant_with_padding([5.0], 4.0, 2)

    assert _twin(pkgs, too_big) == ("raises", "ConstantMaximumError")


def test_add_constant_families(pkgs):
    def scenario(ns):
        enc = ns.hl.Encoder.new(0.0, 16.0, 6, 1)
        a = ns.hl.VectorRLWE.encode_encrypt_packed(ns.sk, [1.0, 2.0], enc,
                                                   mask_seed=70, noise_seed=71)
        out = a.add_constant_static_encoder([3.0, 4.0])
        out2 = a.add_constant_dynamic_encoder([1.0, 1.0])
        return [out, out.decrypt_decode(ns.sk), out2,
                out2.decrypt_decode(ns.sk)]

    _twin(pkgs, scenario)

    def wrong_count(ns):
        enc = ns.hl.Encoder.new(0.0, 16.0, 6, 1)
        a = ns.hl.VectorRLWE.encode_encrypt_packed(ns.sk, [1.0, 2.0], enc,
                                                   mask_seed=70, noise_seed=71)
        return a.add_constant_static_encoder([3.0])

    assert _twin(pkgs, wrong_count) == ("raises", "DimensionError")


def test_constant_ops_nonpacked_mixed_signs(pkgs):
    def scenario(ns):
        enc = ns.hl.Encoder.new(-4.0, 4.0, 6, 3)
        a = ns.hl.VectorRLWE.encode_encrypt(ns.sk, [1.5, -1.0], enc,
                                            mask_seed=80, noise_seed=81)
        out = a.mul_constant_static_encoder([2, -3])
        out2 = a.mul_constant_with_padding([2.0, -2.0], 4.0, 2)
        return [out, out.decrypt_decode(ns.sk), out2,
                out2.decrypt_decode(ns.sk)]

    _twin(pkgs, scenario)


def test_add_constant_rounding_context(pkgs):
    def scenario(ns):
        enc = ns.hl.Encoder.new_rounding_context(0.0, 16.0, 5, 2)
        a = ns.hl.VectorRLWE.encode_encrypt_packed(ns.sk, [2.0, 6.0], enc,
                                                   mask_seed=82, noise_seed=83)
        out = a.add_constant_static_encoder([3.0, 4.0])
        return [out, out.decrypt_decode(ns.sk)]

    _twin(pkgs, scenario)


def test_save_load_round_trip_across_packages(pkgs, tmp_path):
    """A VectorRLWE saved by either package loads in the other unchanged."""
    enc_args = (0.0, 16.0, 6, 1)
    vs = [ns.hl.VectorRLWE.encode_encrypt_packed(
        ns.sk, [1.0, 7.0, 9.0], ns.hl.Encoder.new(*enc_args), mask_seed=5,
        noise_seed=6) for ns in pkgs]
    _same(vs[0], vs[1])
    for i, v in enumerate(vs):
        path = str(tmp_path / f"v{i}.npz")
        v.save(path)
        _same(v, pkgs[1 - i].hl.VectorRLWE.load(path))


def test_golden_serde_decodes_in_both_packages():
    rsk_j = hl_jax.RLWESecretKey.load(str(GOLDEN / "rlwe_sk.npz"))
    rsk_t = hl_t.RLWESecretKey.load(str(GOLDEN / "rlwe_sk.npz"))
    vj = hl_jax.VectorRLWE.load(str(GOLDEN / "vector_rlwe.npz"))
    vt = hl_t.VectorRLWE.load(str(GOLDEN / "vector_rlwe.npz"))
    _same(vj, vt)
    got_j, got_t = vj.decrypt_decode(rsk_j), vt.decrypt_decode(rsk_t)
    _close(got_j, got_t, "decoded")
    assert got_t.size == vt.nb_valid() > 0


def _random_encoders(mod, rng, count):
    """A list of valid and invalid encoders with every field varied."""
    encs = []
    for _ in range(count):
        kind = rng.integers(0, 4)
        if kind == 0:
            encs.append(mod.Encoder.zero())
            continue
        lo = float(rng.uniform(-10, 5))
        e = mod.Encoder.new(lo, lo + float(rng.uniform(0.5, 20)),
                            int(rng.integers(1, 9)), int(rng.integers(0, 4)))
        e.round = bool(kind == 3)
        encs.append(e)
    return encs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bulk_encoder_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    ej = _random_encoders(enc_jax, np.random.default_rng(seed), 400)
    et = _random_encoders(enc_t, np.random.default_rng(seed), 400)
    fj, ft = enc_jax.EncoderFields.gather(ej), enc_t.EncoderFields.gather(et)
    for name in ("o", "delta", "precision", "padding", "round", "valid"):
        np.testing.assert_array_equal(getattr(ft, name), getattr(fj, name))
    _close(fj.granularity(), ft.granularity(), "granularity")
    msgs = rng.uniform(-12, 30, size=400)
    np.testing.assert_array_equal(enc_t.encode_bulk(ft, msgs),
                                  enc_jax.encode_bulk(fj, msgs))
    np.testing.assert_array_equal(enc_t.opposite_correction_bulk(ft),
                                  enc_jax.opposite_correction_bulk(fj))
    x = rng.integers(0, 1 << 64, size=400, dtype=np.uint64)
    bl = rng.integers(0, 65, size=400)
    np.testing.assert_array_equal(
        enc_t._closest_representable_varbits(x, bl),
        enc_jax._closest_representable_varbits(x, bl))
    var = 2.0 ** rng.uniform(-120, -20, size=400)
    for e in ej + et:
        if e.is_valid():
            e.nb_bit_padding = min(e.nb_bit_padding, 2)
    enc_jax.update_precision_bulk(ej, var)
    enc_t.update_precision_bulk(et, var)
    _same_encoders(ej, et, "update_precision_bulk")
    # zero variance on a valid slot raises in both
    for mod, encs in ((enc_jax, ej), (enc_t, et)):
        with pytest.raises(Exception) as info:
            mod.update_precision_bulk(encs, np.zeros(400))
        assert type(info.value).__name__ == "NoNoiseInCiphertext"
    assert dataclasses.is_dataclass(ft)
