"""The port's examples (concrete_tpu_torch.examples) on the CPU at small
sizes: each main's printed answers (every example also checks its own), and
boolean_gates' and adder_circuit's ciphertexts byte for byte against
concrete_tpu's API on the same seeds and parameters."""

import numpy as np
import pytest

from concrete_tpu import boolean as jbool
from concrete_tpu.boolean import circuits as jcircuits
from concrete_tpu_torch.dispersion import StandardDev
from concrete_tpu_torch.examples import (
    adder_circuit, boolean_gates, fast_mode, function_bootstrap, int4_lut,
    serving, tpu128_codesign,
)
from concrete_tpu_torch.highlevel import LWEParams, RLWEParams
from concrete_tpu_torch.params import BooleanParameters
from concrete_tpu_torch.torus import to_numpy

from common import TINY

TINY_PORT = BooleanParameters(16, 1, 128, StandardDev(2.0 ** -20),
                              StandardDev(2.0 ** -25), 8, 2, 4, 3)
CPU = ["--device", "cpu"]


def jax_keys():
    return jbool.gen_keys(TINY, secret_seed=1, mask_seed=2, noise_seed=3)


def test_boolean_gates_equals_concrete_tpu():
    out = boolean_gates.run("cpu", params=TINY_PORT)
    cks, sks = jax_keys()
    ca = cks.encrypt(boolean_gates.A, mask_seed=4, noise_seed=5)
    cb = cks.encrypt(boolean_gates.B, mask_seed=6, noise_seed=7)
    ct_and = sks.and_(ca, cb)
    np.testing.assert_array_equal(to_numpy(out["and"]), np.asarray(ct_and))
    np.testing.assert_array_equal(to_numpy(out["mux"]),
                                  np.asarray(sks.mux(ct_and, ca, cb)))
    assert out["lines"] == ["a AND b      = [ True False False False]",
                            "mux(and,a,b) = [ True False  True False]"]


def test_adder_circuit_equals_concrete_tpu():
    out = adder_circuit.run("cpu", params=TINY_PORT)
    cks, sks = jax_keys()
    a = jcircuits.encrypt_uint(cks, adder_circuit.A, 8, mask_seed=4,
                               noise_seed=5)
    b = jcircuits.encrypt_uint(cks, adder_circuit.B, 8, mask_seed=6,
                               noise_seed=7)
    sums, carry = jcircuits.ripple_carry_adder(sks, a, b)
    np.testing.assert_array_equal(to_numpy(out["sum"]),
                                  np.asarray(np.stack(sums)))
    np.testing.assert_array_equal(to_numpy(out["carry"]), np.asarray(carry))
    assert out["lines"] == [
        "a + b = [ 42 255 132] (expect [ 42 255 132] ), carry "
        "[False False False]"]


# module, small sizes, a fragment of one of its printed lines
MAINS = [
    (boolean_gates, {"params": TINY_PORT}, "mux(and,a,b) = [ True False  True"),
    (adder_circuit, {"params": TINY_PORT}, "a + b = [ 42 255 132]"),
    (fast_mode, {"params": BooleanParameters(
        16, 1, 128, StandardDev(2.0 ** -20), StandardDev(2.0 ** -25), 7, 3,
        4, 3), "rows": 16}, "chained fast-mode gates: 16/16 correct"),
    (function_bootstrap, {"lwe": LWEParams(32, -30),
                          "rlwe": RLWEParams(256, 1, -40)}, "x^2 = [ 2.3"),
    (int4_lut, {"lwe": LWEParams(64, -30), "rlwe": RLWEParams(256, 1, -50)},
     "-> [1, 4, 0, 12, 14] (expect [1, 4, 0, 12, 14] )"),
    (serving, {"params": TINY_PORT, "tier": 16, "requests": (3, 9, 16)},
     "served 28 gates"),
    (tpu128_codesign, {"params": BooleanParameters(
        256, 1, 256, StandardDev(2.0 ** -20), StandardDev(2.0 ** -25), 8, 2,
        4, 3), "batch": 4}, "top candidate on the H100 model"),
]


@pytest.mark.parametrize("module,sizes,answer", MAINS,
                         ids=[m.__name__.rsplit(".", 1)[1] for m, *_ in MAINS])
def test_example_main_on_the_cpu(module, sizes, answer, capsys):
    lines = module.main(CPU, **sizes)
    assert any(answer in line for line in lines), lines
    printed = capsys.readouterr().out.splitlines()
    assert [p for p in printed if p in lines] == lines


def test_serving_main_reads_a_preset_name():
    with pytest.raises(AttributeError):
        serving.main(CPU + ["NO_SUCH"])
