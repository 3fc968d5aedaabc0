#!/usr/bin/env python3
"""Compute the reference digests of chip_smoke.py's phases F and G with
concrete_tpu (the JAX package) on the CPU:

    JAX_PLATFORMS=cpu python3 tools/phase_f_reference.py [F] [G]

(both without arguments). Phase G (~15 s): from the seeds of
chip_smoke.PHASE_G, an RLWE128_1024_1 key, the two packed VectorRLWEs of
chip_smoke.vrlwe_values (8 ciphertexts x 1024 4-bit messages each), their
add_with_padding times the constants of mul_constant_static_encoder, and the
LWEs of every coefficient of the first (extract_1_lwe in a loop): the
sha256[:16] of each, the DIGESTS_G dict of chip_smoke.py.

Phase F: from the seeds of chip_smoke.PHASE_F it makes the DEFAULT and TFHE_LIB
boolean keys, the int4 high-level keys of examples/int4_lut.py, the
2048-row encrypt_uint planes of the adder's operands, the adder's output on
their first 32 rows (the gates are exact, so these rows are the same in a
2048-row call) and a base_log 8 keyswitch of 64 rows, and prints the
sha256[:16] of each as the DIGESTS dict that chip_smoke.py holds
(~3 minutes, most of it the adder's 24 gate calls at DEFAULT).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def digest(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def phase_g() -> dict:
    from chip_smoke import INT4, PHASE_G, vrlwe_values
    from concrete_tpu import highlevel as hl

    g = PHASE_G
    rsk = hl.RLWESecretKey.new(INT4["rlwe"], secret_seed=g["rlwe_seed"])
    enc = hl.Encoder.new(0.0, 15.0, nb_bit_precision=4, nb_bit_padding=1)
    x, y = vrlwe_values()
    a = hl.VectorRLWE.encode_encrypt_packed(rsk, x, enc, mask_seed=g["a_seeds"][0],
                                            noise_seed=g["a_seeds"][1])
    b = hl.VectorRLWE.encode_encrypt_packed(rsk, y, enc, mask_seed=g["b_seeds"][0],
                                            noise_seed=g["b_seeds"][1])
    out = a.add_with_padding(b).mul_constant_static_encoder(
        np.asarray(g["constants"]))
    consts = np.repeat(np.asarray(g["constants"]), rsk.polynomial_size)
    assert np.array_equal(np.round(out.decrypt_decode(rsk)), consts * (x + y))
    n = a.polynomial_size
    extracted = np.concatenate([
        np.concatenate([a.extract_1_lwe(c, i).data for c in range(n)])
        for i in range(a.nb_ciphertexts)])
    return {"vrlwe a": digest(a.data), "vrlwe b": digest(b.data),
            "vrlwe add_mul": digest(out.data),
            "vrlwe extracted": digest(extracted)}


def phase_f() -> dict:
    import jax.numpy as jnp

    from chip_smoke import PHASE_F, adder_values
    from concrete_tpu import boolean, params
    from concrete_tpu import highlevel as hl
    from concrete_tpu.boolean import circuits
    from concrete_tpu.core import lwe
    from concrete_tpu.csprng import EncryptionRandomGenerator

    f = PHASE_F
    out = {}
    t0 = time.perf_counter()
    s, m, n = f["gate_seeds"]
    keys = {}
    for name in f["presets"]:
        p = getattr(params, f"{name}_PARAMETERS")
        cks, sks = boolean.gen_keys(p, secret_seed=s, mask_seed=m, noise_seed=n)
        keys[name] = (cks, sks)
        out[f"{name} lwe_key"] = digest(cks.lwe_secret_key.key)
        out[f"{name} glwe_key"] = digest(cks.glwe_secret_key.key)
        out[f"{name} bsk"] = digest(sks.bsk_standard)
        out[f"{name} ksk"] = digest(np.asarray(sks.ksk))
    print("boolean keys", time.perf_counter() - t0, file=sys.stderr)
    s_lwe, s_rlwe, bm, bn, km, kn = f["int4_seeds"]
    sk = hl.LWESecretKey.new(hl.LWE128_630, secret_seed=s_lwe)
    rsk = hl.RLWESecretKey.new(hl.RLWE128_1024_1, secret_seed=s_rlwe)
    bsk = hl.LWEBSK.new(sk, rsk, 7, 3, mask_seed=bm, noise_seed=bn)
    ksk = hl.LWEKSK.new(rsk.to_lwe_secret_key(), sk, 2, 8, mask_seed=km,
                        noise_seed=kn)
    out["int4 lwe_key"] = digest(sk.inner.key)
    out["int4 rlwe_key"] = digest(rsk.inner.key)
    out["int4 bsk"] = digest(bsk.coefficient_bsk)
    out["int4 ksk"] = digest(ksk.inner.data)
    print("int4 keys", time.perf_counter() - t0, file=sys.stderr)

    cks, sks = keys["DEFAULT"]
    a, b = adder_values()
    a_bits = circuits.encrypt_uint(cks, a, f["nbits"], mask_seed=f["a_seeds"][0],
                                   noise_seed=f["a_seeds"][1])
    b_bits = circuits.encrypt_uint(cks, b, f["nbits"], mask_seed=f["b_seeds"][0],
                                   noise_seed=f["b_seeds"][1])
    out["a planes"] = digest(a_bits)
    out["b planes"] = digest(b_bits)
    r = f["ref_rows"]
    sums, carry = circuits.ripple_carry_adder(sks, a_bits[:, :r], b_bits[:, :r])
    sums, carry = np.asarray(sums), np.asarray(carry)
    got = circuits.decrypt_uint(cks, sums)
    assert np.array_equal(got, (a[:r] + b[:r]) % 256), got
    out["adder sums"] = digest(sums)
    out["adder carry"] = digest(carry)
    print("adder", time.perf_counter() - t0, file=sys.stderr)

    big = cks.glwe_secret_key.into_lwe_key()
    bl, lv = f["ks"]
    std = params.DEFAULT_PARAMETERS.lwe_modular_std_dev.std_dev
    kskey = lwe.LweKeyswitchKey.generate(
        big, cks.lwe_secret_key, bl, lv, std,
        EncryptionRandomGenerator(*f["ks_seeds"]))
    msgs = np.arange(f["ks_rows"], dtype=np.uint32) << np.uint32(24)
    cts = big.encrypt(msgs, std, EncryptionRandomGenerator(*f["ks_ct_seeds"]))
    ks_out = np.asarray(lwe.keyswitch(jnp.asarray(kskey.data), jnp.asarray(cts),
                                      base_log=bl, level_count=lv))
    out["ks key"] = digest(kskey.data)
    out["ks out"] = digest(ks_out)
    return out


def main():
    phases = sys.argv[1:] or ["F", "G"]
    for name, fn in (("F", phase_f), ("G", phase_g)):
        if name in phases:
            t0 = time.perf_counter()
            out = fn()
            print(f"phase {name}", time.perf_counter() - t0, file=sys.stderr)
            print(f"DIGESTS{'' if name == 'F' else '_G'} =",
                  json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
