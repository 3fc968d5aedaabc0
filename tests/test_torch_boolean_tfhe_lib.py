"""The tfhe library's gate parameters (TFHE_LIB_PARAMETERS: k=1, N=1024,
PBS bl 7 l 3, KS bl 2 l 8) through ServerKey on the CPU, against the
benchmark's plain reference (portbench/plain/boolean.py): every word equal
and the booleans equal to the truth table, with only the LWE dimension cut
(630 to 8; a full-width gate takes over a minute here). Also: the
benchmark configuration boolean_tfhe_lib is the preset field by field, and
the yardstick's work count of its gate call is the program's own."""

import dataclasses

import pytest
import torch

from concrete_tpu_torch import design, profiling
from concrete_tpu_torch.boolean import ServerKey
from concrete_tpu_torch.core.bootstrap import ServerConfig
from concrete_tpu_torch.dispersion import StandardDev
from concrete_tpu_torch.params import TFHE_LIB_PARAMETERS, BooleanParameters
from concrete_tpu_torch.torus import to_numpy
from portbench import harness, yardstick
from portbench.plain import boolean as plain

CONFIG = harness.ROOT / "portbench" / "configs" / "boolean_tfhe_lib.json"
CUT = dataclasses.replace(TFHE_LIB_PARAMETERS, lwe_dimension=8)
ROWS = 5
METHODS = {"and": "and_", "nand": "nand", "or": "or_", "xor": "xor",
           "mux": "mux"}


def _plain_params(params: BooleanParameters) -> dict:
    """The parameters as the benchmark's configuration files give them."""
    out = {}
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        out[f.name] = v.std_dev if isinstance(v, StandardDev) else v
    return out


@pytest.fixture(scope="module")
def keys():
    """The plain reference's keys from a seed, and the ServerKey of their
    standard forms on the CPU (backend "auto")."""
    gen = torch.Generator().manual_seed(23)
    p = dict(_plain_params(CUT), bits=32)
    ref = plain.make_keys(gen, p, "cpu")
    sks = ServerKey.from_arrays(to_numpy(ref["bsk"].to(torch.int32)),
                                to_numpy(ref["ksk"].to(torch.int32)),
                                CUT, device="cpu")
    return gen, p, ref, sks


@pytest.mark.parametrize("gate", list(METHODS))
def test_gate_matches_the_plain_reference(keys, gate):
    gen, p, ref, sks = keys
    assert sks.resolved_backend() == "ntt"
    bits = [torch.randint(0, 2, (ROWS,), generator=gen).bool()
            for _ in range(plain.OPERANDS[gate])]
    cts = [plain.encrypt(gen, ref, p, b) for b in bits]
    got = getattr(sks, METHODS[gate])(
        *[to_numpy(c.to(torch.int32)) for c in cts])
    assert got.shape == (ROWS, CUT.lwe_dimension + 1)
    got = got.to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(got, plain.gate(ref, p, gate, cts))
    assert torch.equal(plain.decrypt(ref, got), plain.truth(gate, bits))


def test_config_is_the_preset():
    conf = harness.load_json(CONFIG)
    assert conf["parameters"] == _plain_params(TFHE_LIB_PARAMETERS)
    assert conf["reduced"] == [] and conf["control"] == {"levels": 2}


@pytest.mark.parametrize("batch", [16, 2048])
def test_yardstick_gate_work(batch):
    """The yardstick's gate call at the configuration is n CMux steps of
    the program's own count plus the keyswitch's int8 product, and at 2048
    rows K9's integer work bounds it: 630 steps of 67.8 us."""
    p = dict(harness.load_json(CONFIG)["parameters"], bits=32)
    work = yardstick.ntt_gate_work(p, batch, batch, 2)
    cfg = ServerConfig.from_boolean_parameters(TFHE_LIB_PARAMETERS)
    step = profiling.ntt_cmux_work(cfg, batch)[1]
    assert work.int_instr == tuple(cfg.lwe_dimension * x for x in step)
    assert work.int8_ops == design._ks_int8_ops(TFHE_LIB_PARAMETERS, batch)
    if batch == 2048:
        assert work.bound_seconds() == yardstick.int_ops_s(*work.int_instr)
        assert work.bound_seconds() == pytest.approx(630 * 67.8e-6,
                                                     rel=0.005)
