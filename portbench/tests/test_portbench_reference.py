"""The plain reference against the program run with device="cpu" at tiny
sizes: every gate and the int4 table PBS + keyswitch, word for word, and
the reference's pieces against plain integer arithmetic."""

import numpy as np
import pytest
import torch

from conftest import TINY_BOOLEAN, TINY_INT4
from portbench.plain import boolean as pbool
from portbench.plain import int4_lut as pint4
from portbench.plain import tfhe

CPU = torch.device("cpu")


def naive_negacyclic(a: list[int], b: list[int], bits: int) -> list[int]:
    n = len(a)
    out = [0] * n
    for i in range(n):
        for j in range(n):
            k = i + j
            if k < n:
                out[k] += a[i] * b[j]
            else:
                out[k - n] -= a[i] * b[j]
    return [v % (1 << bits) for v in out]


@pytest.mark.parametrize("bits,digit_max", [(32, 128), (64, 64), (64, 2)])
def test_negacyclic_dot_is_exact(bits, digit_max):
    gen = torch.Generator().manual_seed(bits + digit_max)
    n, r, c = 16, 3, 2
    digits = torch.randint(-digit_max, digit_max + 1, (2, r, n), generator=gen)
    polys = tfhe.uniform(gen, (r, c, n), bits, CPU)
    got = tfhe.negacyclic_dot(digits, polys, bits, digit_max)
    for b in range(2):
        for col in range(c):
            want = [0] * n
            for row in range(r):
                prod = naive_negacyclic(
                    digits[b, row].tolist(),
                    [v % (1 << bits) for v in polys[row, col].tolist()], bits)
                want = [(x + y) % (1 << bits) for x, y in zip(want, prod)]
            assert [v % (1 << bits) for v in got[b, col].tolist()] == want


def test_decompositions_recompose():
    """Both digit rules give signed digits that recompose the rounded
    value."""
    gen = torch.Generator().manual_seed(3)
    for bits, bl, lv in [(32, 8, 2), (64, 7, 3), (32, 2, 5), (64, 2, 8)]:
        x = tfhe.uniform(gen, (4096,), bits, CPU)
        width = bl * lv
        rounded = (((tfhe.lshr(x, bits - width - 1, bits) + 1) >> 1)
                   % (1 << width))
        for fn in (tfhe.gadget_digits, tfhe.keyswitch_digits):
            d = fn(x, bl, lv, bits)
            assert int(d.abs().max()) <= 1 << (bl - 1)
            back = sum(d[..., j] * (1 << (bl * (lv - 1 - j)))
                       for j in range(lv)) % (1 << width)
            assert torch.equal(back, rounded)


def _boolean_server(keys, p):
    from concrete_tpu_torch.boolean import ServerKey
    from concrete_tpu_torch.dispersion import StandardDev
    from concrete_tpu_torch.params import BooleanParameters

    params = BooleanParameters(
        p["lwe_dimension"], p["glwe_dimension"], p["polynomial_size"],
        StandardDev(p["lwe_modular_std_dev"]),
        StandardDev(p["glwe_modular_std_dev"]), p["pbs_base_log"],
        p["pbs_level"], p["ks_base_log"], p["ks_level"])
    u32 = (lambda t: t.to(torch.int32).numpy().view(np.uint32))
    return ServerKey.from_arrays(u32(keys["bsk"]), u32(keys["ksk"]), params,
                                 device="cpu")


@pytest.mark.parametrize("gate", ["and", "nand", "or", "xor", "mux"])
def test_gates_equal_the_program(gate):
    p = dict(TINY_BOOLEAN, bits=32)
    gen = torch.Generator().manual_seed(11)
    keys = pbool.make_keys(gen, p, CPU)
    server = _boolean_server(keys, p)
    bits = [torch.randint(0, 2, (24,), generator=gen).bool()
            for _ in range(pbool.OPERANDS[gate])]
    cts = [pbool.encrypt(gen, keys, p, b) for b in bits]
    method = {"and": "and_", "or": "or_"}.get(gate, gate)
    got = getattr(server, method)(
        *[c.to(torch.int32).numpy().view(np.uint32) for c in cts])
    got = torch.from_numpy(got.numpy().view(np.uint32).astype(np.int64))
    want = pbool.gate(keys, p, gate, cts)
    assert torch.equal(got, want)
    assert torch.equal(pbool.decrypt(keys, want), pbool.truth(gate, bits))


def _int4_program(keys, p):
    from concrete_tpu_torch.core.lwe import LweKeyswitchKey
    from concrete_tpu_torch.highlevel import LWEBSK, LWEKSK

    u64 = (lambda t: t.numpy().view(np.uint64))
    bsk = LWEBSK(cfg=LWEBSK._config(p["lwe_dimension"], p["glwe_dimension"],
                                    p["polynomial_size"], p["pbs_base_log"],
                                    p["pbs_level"]),
                 variance=4.0 ** p["rlwe_log2_std_dev"],
                 coefficient_bsk=u64(keys["bsk"]), device="cpu")
    ksk = LWEKSK(inner=LweKeyswitchKey(u64(keys["ksk"]), p["ks_base_log"],
                                       p["ks_level"], 64),
                 variance=4.0 ** p["lwe_log2_std_dev"], device="cpu")
    return bsk, ksk


ENC = {"min": 0.0, "max": 15.0, "precision": 4, "padding": 1}
TABLES = {"affine": [(3 * x + 1) % 16 for x in range(16)],
          "relu8": [max(x - 8, 0) for x in range(16)]}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_test_polynomial_equals_the_program(name):
    from concrete_tpu_torch.highlevel import Encoder
    from concrete_tpu_torch.highlevel.lwe import generate_functional_lut

    p = dict(TINY_INT4, bits=64)
    keys = pint4.make_keys(torch.Generator().manual_seed(1), p, CPU)
    bsk, _ = _int4_program(keys, p)
    enc = Encoder.new(0.0, 15.0, 4, 1)
    got = generate_functional_lut(bsk, enc, enc, pint4.function(TABLES[name]))
    want = pint4.test_polynomial(TABLES[name], ENC, ENC, p["polynomial_size"])
    assert [int(v) for v in got] == want


def test_int4_pbs_keyswitch_equals_the_program():
    from concrete_tpu_torch.highlevel import Encoder, VectorLWE

    p = dict(TINY_INT4, bits=64)
    gen = torch.Generator().manual_seed(5)
    keys = pint4.make_keys(gen, p, CPU)
    bsk, ksk = _int4_program(keys, p)
    values = torch.arange(16).repeat(2)
    cts = pint4.encrypt(gen, keys, p, ENC, values)
    enc = Encoder.new(0.0, 15.0, 4, 1)
    vec = VectorLWE(cts.numpy().view(np.uint64), [enc.copy() for _ in values],
                    np.full(len(values), 4.0 ** p["lwe_log2_std_dev"]))
    table = TABLES["affine"]
    pbs = vec.bootstrap_all_with_function(bsk, pint4.function(table), enc)
    small = pbs.keyswitch(ksk)
    poly = torch.tensor(pint4.as_signed(pint4.test_polynomial(
        table, ENC, ENC, p["polynomial_size"])))
    want_big, want_small = pint4.pbs_keyswitch(
        keys, p, cts, poly.expand(len(values), -1))
    assert torch.equal(torch.from_numpy(pbs.data.view(np.int64)), want_big)
    assert torch.equal(torch.from_numpy(small.data.view(np.int64)),
                       want_small)
    expect = torch.tensor(table)[values]
    assert torch.equal(pint4.decode_ints(keys, want_big, ENC, True), expect)
    assert torch.equal(pint4.decode_ints(keys, want_small, ENC, False),
                       expect)
