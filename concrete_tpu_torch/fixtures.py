"""Backend-conformance fixtures: the concrete-core-fixture analog.

The reference's flagship test layer (concrete-core-fixture/src/fixture/mod.rs)
runs each operation through: parameters -> repetitions (fresh keys) ->
samples (fresh ciphertexts) -> execute -> compute NPE criteria -> statistical
verify. The port of concrete_tpu/fixtures.py: the same 30 fixtures, entries,
repetitions, sample sizes, seeds and criteria; keys and ciphertexts come from
the AES-CTR streams, so every sample equals concrete_tpu's bit for bit. The
server-side ops run on `device` (stress / run_all: the GPU unless
device="cpu"), on the backends mxu, nuss and ntt, and so do the
polynomial products of GLWE / GGSW encryption and decryption. LWE
encryption and decryption are numpy dot products on the host, as in
concrete_tpu.

Every noisy op is verified against the NPE oracle with the same statistical
machinery the reference uses (KS test + sigma bounds,
raw/statistical_test.rs:14-93).

Example:
    >>> from concrete_tpu_torch.fixtures import ALL_FIXTURES, SampleExtractFixture
    >>> len(ALL_FIXTURES), len({f.name for f in ALL_FIXTURES})
    (30, 30)
    >>> [r.passed for r in SampleExtractFixture().stress(1, 16, device="cpu")]
    [True, True]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import npe
from .core import bootstrap as bs
from .core import bootstrap_mxu as bsx
from .core import bootstrap_ntt as bsntt
from .core import bootstrap_nuss as bsn
from .core import lwe as lwe_mod
from .core import glwe as glwe_mod
from .core.ggsw import StandardBootstrapKey, bsk_to_ntt
from .csprng import EncryptionRandomGenerator, SecretRandomGenerator
from .dispersion import StandardDev, Variance
from .ops._cuda import resolve_device
from .testing import assert_noise_bounded, assert_noise_distribution
from .torus import from_numpy, to_numpy


def _rings_mxu(ggsw_or_bsk, cfg, device) -> torch.Tensor:
    """bsk_to_mxu's rings (host numpy) as an int32 tensor on `device`."""
    return torch.from_numpy(
        bsx.bsk_to_mxu(ggsw_or_bsk, cfg).view(np.int32)).to(device)


@dataclasses.dataclass
class FixtureReport:
    name: str
    parameters: dict
    repetitions: int
    sample_size: int
    passed: bool
    detail: str = ""


class Fixture:
    """Protocol: stress() runs REPETITIONS x (keys -> SAMPLE_SIZE samples ->
    execute -> verify against criteria) per parameter set
    (fixture/mod.rs:122-203). The server-side ops of run_one run on
    `self.device` (set by stress; None resolves to the GPU)."""

    name = "fixture"
    PARAMETERS: list = []
    REPETITIONS = 10   # concrete-core-test/src/lib.rs:10
    SAMPLE_SIZE = 100  # concrete-core-test/src/lib.rs:13
    device = None

    @property
    def dev(self) -> torch.device:
        return resolve_device(self.device)

    def run_one(self, params: dict, rep_seed: int):
        raise NotImplementedError

    def stress(self, repetitions=None, sample_size=None, device=None) -> list:
        self.device = resolve_device(device)
        reps = repetitions or self.REPETITIONS
        if sample_size:
            self.SAMPLE_SIZE = sample_size
        reports = []
        for params in self.PARAMETERS:
            # heavyweight entries (e.g. the N=8192 Nussbaumer shapes) cap
            # their own repetition count so the CPU grid stays tractable
            entry_reps = min(reps, params.get("reps", reps))
            ok, detail = True, ""
            for rep in range(entry_reps):
                try:
                    self.run_one(params, rep_seed=1000 * rep + 7)
                except AssertionError as e:
                    ok, detail = False, str(e)
                    break
            reports.append(
                FixtureReport(self.name, params, entry_reps,
                              params.get("samples", self.SAMPLE_SIZE), ok,
                              detail)
            )
        return reports


class LweEncryptDecryptFixture(Fixture):
    """Fresh-encryption noise matches the configured gaussian (KS test)."""

    name = "lwe_encrypt_decrypt"
    PARAMETERS = [
        {"dim": 128, "log_std": -15, "bits": 32},
        {"dim": 128, "log_std": -25, "bits": 64},
    ]

    def run_one(self, params, rep_seed):
        bits = params["bits"]
        sk = lwe_mod.LweSecretKey.generate_binary(
            params["dim"], SecretRandomGenerator(rep_seed), bits
        )
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        std = StandardDev(2.0 ** params["log_std"])
        rng = np.random.default_rng(rep_seed)
        pts = rng.integers(0, 1 << 32, size=self.SAMPLE_SIZE, dtype=np.uint32).astype(
            np.uint64 if bits == 64 else np.uint32
        )
        cts = sk.encrypt(pts, std.std_dev, gen)
        dec = sk.decrypt(cts)
        assert_noise_distribution(dec, pts, std, bits, seed=rep_seed * 31 + 1)


class LweKeyswitchFixture(Fixture):
    """Keyswitch noise <= NPE prediction
    (fixture analog: lwe_ciphertext_discarding_keyswitch)."""

    name = "lwe_keyswitch"
    PARAMETERS = [
        {"n_in": 64, "n_out": 32, "base_log": 4, "levels": 5, "bits": 32},
        {"n_in": 64, "n_out": 32, "base_log": 2, "levels": 8, "bits": 32},
    ]

    def run_one(self, params, rep_seed):
        bits = params["bits"]
        sgen = SecretRandomGenerator(rep_seed)
        in_key = lwe_mod.LweSecretKey.generate_binary(params["n_in"], sgen, bits)
        out_key = lwe_mod.LweSecretKey.generate_binary(params["n_out"], sgen, bits)
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        ks_std = StandardDev(2.0 ** -20)
        ct_std = StandardDev(2.0 ** -18)
        ksk = lwe_mod.LweKeyswitchKey.generate(
            in_key, out_key, params["base_log"], params["levels"], ks_std.std_dev, gen
        )
        rng = np.random.default_rng(rep_seed)
        pts = rng.integers(0, 1 << 32, size=self.SAMPLE_SIZE, dtype=np.uint32)
        cts = in_key.encrypt(pts, ct_std.std_dev, gen)
        out = to_numpy(lwe_mod.keyswitch(
            ksk.data, from_numpy(cts, self.dev),
            base_log=params["base_log"], level_count=params["levels"]))
        dec = out_key.decrypt(out)
        predicted = npe.estimate_keyswitch_noise_with_constant_terms(
            params["n_in"], ct_std, ks_std, params["base_log"], params["levels"], bits
        )
        assert_noise_bounded(dec, pts, predicted, bits, slack_bits=0.5)


class PbsFixture(Fixture):
    """PBS output noise <= NPE prediction
    (fixture/lwe_ciphertext_discarding_bootstrap_1.rs:254-274 analog)."""

    name = "pbs"
    PARAMETERS = [
        {"n": 16, "k": 1, "N": 128, "base_log": 8, "levels": 2, "backend": "ntt"},
        {"n": 12, "k": 2, "N": 64, "base_log": 6, "levels": 3, "backend": "ntt"},
        {"n": 16, "k": 1, "N": 128, "base_log": 8, "levels": 2, "backend": "mxu"},
        {"n": 12, "k": 2, "N": 64, "base_log": 6, "levels": 3, "backend": "mxu"},
        # the TPU128 shape class (k=4, N=256, bl=7, l=2 — params.py), both
        # backends, scaled-down n for CPU CI cost
        {"n": 12, "k": 4, "N": 256, "base_log": 7, "levels": 2, "backend": "ntt"},
        {"n": 12, "k": 4, "N": 256, "base_log": 7, "levels": 2, "backend": "mxu"},
        # the Nussbaumer-domain backend (the large-N production path): a
        # CI-cost entry at L=8 plus the real N=8192 class at reduced reps
        {"n": 12, "k": 1, "N": 512, "base_log": 7, "levels": 2,
         "backend": "nuss", "L": 8},
        {"n": 4, "k": 1, "N": 8192, "base_log": 7, "levels": 2,
         "backend": "nuss", "reps": 2, "samples": 8},
    ]
    SAMPLE_SIZE = 64

    def run_one(self, params, rep_seed):
        from .params import BooleanParameters

        dev = self.dev
        p = BooleanParameters(
            lwe_dimension=params["n"],
            glwe_dimension=params["k"],
            polynomial_size=params["N"],
            lwe_modular_std_dev=StandardDev(2.0 ** -20),
            glwe_modular_std_dev=StandardDev(2.0 ** -25),
            pbs_base_log=params["base_log"],
            pbs_level=params["levels"],
            ks_base_log=2,
            ks_level=5,
        )
        cfg = bs.ServerConfig.from_boolean_parameters(p)
        sgen = SecretRandomGenerator(rep_seed)
        lwe_sk = lwe_mod.LweSecretKey.generate_binary(p.lwe_dimension, sgen)
        glwe_sk = glwe_mod.GlweSecretKey.generate_binary(
            p.glwe_dimension, p.polynomial_size, sgen
        )
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        bsk = StandardBootstrapKey.generate(
            lwe_sk, glwe_sk, p.pbs_base_log, p.pbs_level,
            p.glwe_modular_std_dev.std_dev, gen, device=dev,
        )
        eighth = np.uint32(1 << 29)
        neg_eighth = np.uint32((-(1 << 29)) % (1 << 32))
        rng = np.random.default_rng(rep_seed)
        size = params.get("samples", self.SAMPLE_SIZE)
        signs = rng.integers(0, 2, size=size).astype(bool)
        msgs = np.where(signs, eighth, neg_eighth)
        cts = from_numpy(
            lwe_sk.encrypt(msgs, p.lwe_modular_std_dev.std_dev, gen), dev)
        lut = bs.trivial_lut_constant(cfg, eighth, dev)
        if params.get("backend") == "nuss":
            L = params.get("L")
            rings = bsn.bsk_to_nuss(bsk.data, cfg, L, device=dev)
            out = bsn.bootstrap_nuss(cfg, rings, lut, cts, l=L)
        elif params.get("backend") == "mxu":
            out = bsx.bootstrap_mxu(cfg, _rings_mxu(bsk.data, cfg, dev), lut,
                                    cts)
        else:
            bsk_ntt = bsk_to_ntt(bsk.data, cfg.primes, 32, device=dev)
            out = bsntt.bootstrap(cfg, bsk_ntt, lut, cts)
        dec = glwe_sk.into_lwe_key().decrypt(to_numpy(out))
        expected = np.where(signs, eighth, neg_eighth)
        predicted = npe.estimate_pbs_noise(
            p.lwe_dimension, p.polynomial_size, p.glwe_dimension,
            p.pbs_base_log, p.pbs_level, p.glwe_modular_std_dev, 32,
        )
        return assert_noise_bounded(dec, expected, predicted, 32,
                                    slack_bits=0.5)


class GlweEncryptDecryptFixture(Fixture):
    """GLWE fresh-encryption noise matches the configured gaussian."""

    name = "glwe_encrypt_decrypt"
    PARAMETERS = [
        {"k": 1, "N": 128, "log_std": -20, "bits": 32},
        {"k": 2, "N": 64, "log_std": -20, "bits": 32},
    ]

    def run_one(self, params, rep_seed):
        bits = params["bits"]
        sk = glwe_mod.GlweSecretKey.generate_binary(
            params["k"], params["N"], SecretRandomGenerator(rep_seed), bits
        )
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        std = StandardDev(2.0 ** params["log_std"])
        rng = np.random.default_rng(rep_seed)
        count = max(2, self.SAMPLE_SIZE // params["N"])
        msgs = rng.integers(0, 1 << 32, size=(count, params["N"]), dtype=np.uint32)
        cts = sk.encrypt(msgs, std.std_dev, gen, self.dev)
        dec = sk.decrypt(cts, self.dev)
        assert_noise_distribution(dec, msgs, std, bits, seed=rep_seed * 17 + 3)


class ExternalProductFixture(Fixture):
    """External product noise <= NPE prediction (binary GGSW)."""

    name = "external_product"
    PARAMETERS = [
        {"k": 1, "N": 128, "base_log": 8, "levels": 2, "backend": "ntt"},
        {"k": 2, "N": 64, "base_log": 6, "levels": 3, "backend": "ntt"},
        {"k": 1, "N": 128, "base_log": 8, "levels": 2, "backend": "mxu"},
        {"k": 2, "N": 64, "base_log": 6, "levels": 3, "backend": "mxu"},
        {"k": 4, "N": 256, "base_log": 7, "levels": 2, "backend": "mxu"},
    ]
    SAMPLE_SIZE = 32

    def run_one(self, params, rep_seed):
        from .core.ggsw import encrypt_constant_ggsw, ggsw_to_ntt
        from .params import BooleanParameters

        p = BooleanParameters(
            lwe_dimension=8,
            glwe_dimension=params["k"],
            polynomial_size=params["N"],
            lwe_modular_std_dev=StandardDev(2.0 ** -20),
            glwe_modular_std_dev=StandardDev(2.0 ** -25),
            pbs_base_log=params["base_log"],
            pbs_level=params["levels"],
            ks_base_log=2,
            ks_level=5,
        )
        cfg = bs.ServerConfig.from_boolean_parameters(p)
        sk = glwe_mod.GlweSecretKey.generate_binary(
            params["k"], params["N"], SecretRandomGenerator(rep_seed)
        )
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        ggsw_std = StandardDev(2.0 ** -25)
        ct_std = StandardDev(2.0 ** -20)
        ggsw = encrypt_constant_ggsw(
            sk, 1, params["base_log"], params["levels"], ggsw_std.std_dev, gen,
            device=self.dev)
        rng = np.random.default_rng(rep_seed)
        msgs = rng.integers(0, 1 << 32, size=(self.SAMPLE_SIZE, params["N"]), dtype=np.uint32)
        cts = from_numpy(sk.encrypt(msgs, ct_std.std_dev, gen, self.dev), self.dev)
        if params.get("backend") == "mxu":
            rings = _rings_mxu(ggsw[None], cfg, self.dev)[0]
            out = bsx.external_product_mxu(cfg, rings, cts)
        else:
            ggsw_ntt = ggsw_to_ntt(ggsw, cfg.primes, 32, device=self.dev)
            out = bsntt.external_product(cfg, ggsw_ntt, cts)
        dec = sk.decrypt(out, self.dev)
        # the fixture drives a DETERMINISTIC GGSW(1): the rounding terms are
        # 2x the binary-averaged formula's (E[m^2] = 1 vs 1/2) — round 3
        # measured exactly that gap at kN >= 256
        predicted = npe.estimate_external_product_noise_with_ggsw_message(
            params["N"], params["k"], ct_std, ggsw_std,
            params["base_log"], params["levels"], 32,
            msg_mean=1.0, msg_second_moment=1.0,
        )
        assert_noise_bounded(dec, msgs, predicted, 32, slack_bits=0.5)


class PackingKeyswitchFixture(Fixture):
    """LWE -> GLWE keyswitch noise within the NPE keyswitch bound."""

    name = "packing_keyswitch"
    PARAMETERS = [{"n_in": 32, "k": 1, "N": 64, "base_log": 6, "levels": 4}]
    SAMPLE_SIZE = 64

    def run_one(self, params, rep_seed):
        from .core import packing
        from .core.lwe import LweSecretKey

        sgen = SecretRandomGenerator(rep_seed)
        lwe_sk = LweSecretKey.generate_binary(params["n_in"], sgen)
        glwe_sk = glwe_mod.GlweSecretKey.generate_binary(params["k"], params["N"], sgen)
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        ks_std = StandardDev(2.0 ** -25)
        ct_std = StandardDev(2.0 ** -20)
        pksk = packing.PackingKeyswitchKey.generate(
            lwe_sk, glwe_sk, params["base_log"], params["levels"], ks_std.std_dev, gen
        )
        rng = np.random.default_rng(rep_seed)
        pts = rng.integers(0, 1 << 32, size=self.SAMPLE_SIZE, dtype=np.uint32)
        cts = lwe_sk.encrypt(pts, ct_std.std_dev, gen)
        out = packing.keyswitch_lwe_to_glwe(
            pksk.data, from_numpy(cts, self.dev),
            base_log=params["base_log"], level_count=params["levels"])
        dec = glwe_sk.decrypt(out, self.dev)[:, 0]
        predicted = npe.estimate_keyswitch_noise_with_constant_terms(
            params["n_in"], ct_std, ks_std, params["base_log"], params["levels"], 32
        )
        assert_noise_bounded(dec, pts, predicted, 32, slack_bits=0.5)


class LweAffineTransformFixture(Fixture):
    """Weighted-sum noise matches the NPE weighted-sum formula
    (lwe_ciphertext_vector_discarding_affine_transformation analog)."""

    name = "lwe_affine_transform"
    PARAMETERS = [{"dim": 128, "count": 4, "log_std": -20, "bits": 32}]

    def run_one(self, params, rep_seed):
        bits = params["bits"]
        sk = lwe_mod.LweSecretKey.generate_binary(
            params["dim"], SecretRandomGenerator(rep_seed), bits)
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        std = StandardDev(2.0 ** params["log_std"])
        rng = np.random.default_rng(rep_seed)
        count = params["count"]
        weights = rng.integers(1, 8, size=count).astype(np.int64)
        bias = np.uint32(rng.integers(0, 1 << 32))
        pts = rng.integers(0, 1 << 32, size=(count, self.SAMPLE_SIZE), dtype=np.uint32)
        cts = np.stack([sk.encrypt(p, std.std_dev, gen) for p in pts], axis=1)
        out = to_numpy(lwe_mod.affine_transform(
            from_numpy(cts, self.dev), tuple(int(w) for w in weights), bias)
        )  # cts: [SAMPLE, count, n+1] -> out [SAMPLE, n+1]
        with np.errstate(over="ignore"):
            expected = (pts.astype(np.uint64) * weights[:, None].astype(np.uint64)).sum(0) + bias
        expected = expected.astype(np.uint32)
        predicted = npe.estimate_weighted_sum_noise(
            [Variance(std.get_variance())] * count, weights.tolist())
        assert_noise_bounded(sk.decrypt(out), expected, predicted, bits, slack_bits=0.5)


class SampleExtractFixture(Fixture):
    """Coefficient extraction is exact on zero-noise GLWEs at every degree
    (lwe_ciphertext_discarding_extraction analog)."""

    name = "sample_extract"
    PARAMETERS = [{"k": 1, "N": 64}, {"k": 2, "N": 128}]

    def run_one(self, params, rep_seed):
        sk = glwe_mod.GlweSecretKey.generate_binary(
            params["k"], params["N"], SecretRandomGenerator(rep_seed))
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        rng = np.random.default_rng(rep_seed)
        pt = rng.integers(0, 1 << 32, size=(1, params["N"]), dtype=np.uint32)
        ct = sk.encrypt(pt, 0.0, gen, self.dev)
        big = sk.into_lwe_key()
        for p in [0, 1, params["N"] // 2, params["N"] - 1]:
            out = to_numpy(bs.sample_extract_nth(from_numpy(ct, self.dev), p))
            assert big.decrypt(out[None])[0] == pt[0, p], p


class CmuxFixture(Fixture):
    """CMux selects the right branch and stays within the NPE cmux bound."""

    name = "cmux"
    PARAMETERS = [
        {"k": 1, "N": 128, "base_log": 8, "levels": 2, "backend": "ntt"},
        {"k": 1, "N": 128, "base_log": 8, "levels": 2, "backend": "mxu"},
        {"k": 4, "N": 256, "base_log": 7, "levels": 2, "backend": "mxu"},
    ]
    SAMPLE_SIZE = 32

    def run_one(self, params, rep_seed):
        from .core.ggsw import encrypt_constant_ggsw, ggsw_to_ntt
        from .params import BooleanParameters

        p = BooleanParameters(
            lwe_dimension=8,
            glwe_dimension=params["k"],
            polynomial_size=params["N"],
            lwe_modular_std_dev=StandardDev(2.0 ** -20),
            glwe_modular_std_dev=StandardDev(2.0 ** -25),
            pbs_base_log=params["base_log"],
            pbs_level=params["levels"],
            ks_base_log=2,
            ks_level=5,
        )
        cfg = bs.ServerConfig.from_boolean_parameters(p)
        sk = glwe_mod.GlweSecretKey.generate_binary(
            params["k"], params["N"], SecretRandomGenerator(rep_seed))
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        rng = np.random.default_rng(rep_seed)
        for bit in (0, 1):
            ggsw = encrypt_constant_ggsw(
                sk, bit, params["base_log"], params["levels"], 2.0 ** -25, gen,
                device=self.dev)
            m0 = rng.integers(0, 1 << 32, size=(self.SAMPLE_SIZE, params["N"]),
                              dtype=np.uint32)
            m1 = rng.integers(0, 1 << 32, size=(self.SAMPLE_SIZE, params["N"]),
                              dtype=np.uint32)
            ct0 = from_numpy(sk.encrypt(m0, 2.0 ** -20, gen, self.dev), self.dev)
            ct1 = from_numpy(sk.encrypt(m1, 2.0 ** -20, gen, self.dev), self.dev)
            if params.get("backend") == "mxu":
                rings = _rings_mxu(ggsw[None], cfg, self.dev)[0]
                out = bsx.cmux_mxu(cfg, rings, ct0, ct1)
            else:
                g_ntt = ggsw_to_ntt(ggsw, cfg.primes, 32, device=self.dev)
                out = bsntt.cmux(cfg, g_ntt, ct0, ct1)
            dec = sk.decrypt(out, self.dev)
            want = m1 if bit else m0
            # per-bit GGSW message moments (the selector is deterministic
            # in each branch of this fixture, not bootstrap-key binary)
            ep = npe.estimate_external_product_noise_with_ggsw_message(
                params["N"], params["k"],
                npe.estimate_addition_noise(
                    StandardDev(2.0 ** -20), StandardDev(2.0 ** -20), 32),
                StandardDev(2.0 ** -25),
                params["base_log"], params["levels"], 32,
                msg_mean=float(bit), msg_second_moment=float(bit),
            )
            predicted = npe.estimate_addition_noise(
                ep, StandardDev(2.0 ** -20), 32)
            assert_noise_bounded(dec, want, predicted, 32, slack_bits=0.5)


class U64PbsFixture(Fixture):
    """u64-torus PBS (the highlevel regime) within the NPE bound, both
    backends — Precision64 of the reference's fixture instantiation."""

    name = "pbs_u64"
    PARAMETERS = [
        {"n": 10, "k": 1, "N": 64, "base_log": 10, "levels": 3, "backend": "ntt"},
        {"n": 10, "k": 1, "N": 64, "base_log": 10, "levels": 3, "backend": "mxu"},
        # the co-designed u64 shape class (k=4 at fixed kN — 2.5x the
        # (1, N') PBS rate at lower noise, docs/performance.md)
        {"n": 8, "k": 4, "N": 64, "base_log": 7, "levels": 3, "backend": "mxu"},
        # the u64 Nussbaumer backend (large-N highlevel regime)
        {"n": 8, "k": 1, "N": 128, "base_log": 7, "levels": 3,
         "backend": "nuss", "L": 4},
    ]
    SAMPLE_SIZE = 32

    def run_one(self, params, rep_seed):
        dev = self.dev
        cfg = bs.ServerConfig(
            lwe_dimension=params["n"], glwe_dimension=params["k"],
            polynomial_size=params["N"], pbs_base_log=params["base_log"],
            pbs_level=params["levels"], ks_base_log=4, ks_level=3, bits=64)
        sgen = SecretRandomGenerator(rep_seed)
        lwe_sk = lwe_mod.LweSecretKey.generate_binary(params["n"], sgen, bits=64)
        glwe_sk = glwe_mod.GlweSecretKey.generate_binary(
            params["k"], params["N"], sgen, bits=64)
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        bsk_std = StandardDev(2.0 ** -45)
        bsk = StandardBootstrapKey.generate(
            lwe_sk, glwe_sk, params["base_log"], params["levels"],
            bsk_std.std_dev, gen, device=dev)
        big = np.uint64(1) << np.uint64(60)
        neg = (np.uint64(0) - big).astype(np.uint64)
        rng = np.random.default_rng(rep_seed)
        size = params.get("samples", self.SAMPLE_SIZE)
        signs = rng.integers(0, 2, size=size).astype(bool)
        msgs = np.where(signs, big, neg)
        cts = from_numpy(lwe_sk.encrypt(msgs, 2.0 ** -30, gen), dev)
        lut = bs.trivial_lut_constant(cfg, big, dev)
        if params.get("backend") == "nuss":
            L = params.get("L")
            rings = bsn.bsk_to_nuss(bsk.data, cfg, L, device=dev)
            out = bsn.bootstrap_nuss(cfg, rings, lut, cts, l=L)
        elif params.get("backend") == "mxu":
            out = bsx.bootstrap_mxu(cfg, _rings_mxu(bsk.data, cfg, dev), lut,
                                    cts)
        else:
            bsk_ntt = bsk_to_ntt(bsk.data, cfg.primes, 64, device=dev)
            out = bsntt.bootstrap(cfg, bsk_ntt, lut, cts)
        dec = glwe_sk.into_lwe_key().decrypt(to_numpy(out))
        predicted = npe.estimate_pbs_noise(
            params["n"], params["N"], params["k"], params["base_log"],
            params["levels"], bsk_std, 64)
        return assert_noise_bounded(dec, msgs, predicted, 64, slack_bits=0.5)


class LweTrivialEncryptFixture(Fixture):
    """Trivial LWE encryption decrypts exactly under ANY key
    (lwe_ciphertext_trivial_encryption/decryption fixtures)."""

    name = "lwe_trivial_encrypt"
    PARAMETERS = [{"dim": 64, "bits": 32}, {"dim": 64, "bits": 64}]

    def run_one(self, params, rep_seed):
        bits = params["bits"]
        sk = lwe_mod.LweSecretKey.generate_binary(
            params["dim"], SecretRandomGenerator(rep_seed), bits)
        rng = np.random.default_rng(rep_seed)
        dt = np.uint64 if bits == 64 else np.uint32
        pts = rng.integers(0, 1 << 32, size=self.SAMPLE_SIZE, dtype=np.uint32).astype(dt)
        cts = lwe_mod.trivial_encrypt(pts, params["dim"], bits, self.dev)
        np.testing.assert_array_equal(to_numpy(lwe_mod.trivial_decrypt(cts)), pts)
        np.testing.assert_array_equal(sk.decrypt(to_numpy(cts)), pts)


class GlweTrivialEncryptFixture(Fixture):
    """Trivial GLWE encryption decrypts exactly under any key
    (glwe_ciphertext_trivial_encryption fixture)."""

    name = "glwe_trivial_encrypt"
    PARAMETERS = [{"k": 1, "N": 64}, {"k": 2, "N": 128}]

    def run_one(self, params, rep_seed):
        sk = glwe_mod.GlweSecretKey.generate_binary(
            params["k"], params["N"], SecretRandomGenerator(rep_seed))
        rng = np.random.default_rng(rep_seed)
        count = max(2, self.SAMPLE_SIZE // params["N"])
        pts = rng.integers(0, 1 << 32, size=(count, params["N"]), dtype=np.uint32)
        cts = glwe_mod.trivial_encrypt(pts, params["k"], device=self.dev)
        np.testing.assert_array_equal(to_numpy(glwe_mod.trivial_decrypt(cts)), pts)
        np.testing.assert_array_equal(sk.decrypt(cts, self.dev), pts)


class LweListEncryptFixture(Fixture):
    """Vector (list) encryption: each slot's noise matches the gaussian
    (lwe_ciphertext_vector_encryption fixture analog)."""

    name = "lwe_list_encrypt"
    PARAMETERS = [{"dim": 96, "log_std": -17, "bits": 32},
                  {"dim": 96, "log_std": -30, "bits": 64}]

    def run_one(self, params, rep_seed):
        bits = params["bits"]
        sk = lwe_mod.LweSecretKey.generate_binary(
            params["dim"], SecretRandomGenerator(rep_seed), bits)
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        std = StandardDev(2.0 ** params["log_std"])
        rng = np.random.default_rng(rep_seed)
        dt = np.uint64 if bits == 64 else np.uint32
        pts = rng.integers(0, 1 << 32, size=(4, self.SAMPLE_SIZE // 4),
                           dtype=np.uint32).astype(dt)
        cts = sk.encrypt(pts, std.std_dev, gen)          # leading list shape
        dec = sk.decrypt(cts)
        assert_noise_distribution(
            dec.ravel(), pts.ravel(), std, bits, seed=rep_seed * 13 + 5)


class GlweListEncryptFixture(Fixture):
    """GLWE list encryption noise (glwe_ciphertext_vector_encryption)."""

    name = "glwe_list_encrypt"
    PARAMETERS = [{"k": 1, "N": 64, "log_std": -20}]

    def run_one(self, params, rep_seed):
        sk = glwe_mod.GlweSecretKey.generate_binary(
            params["k"], params["N"], SecretRandomGenerator(rep_seed))
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        std = StandardDev(2.0 ** params["log_std"])
        rng = np.random.default_rng(rep_seed)
        pts = rng.integers(0, 1 << 32, size=(3, 2, params["N"]), dtype=np.uint32)
        cts = sk.encrypt(pts, std.std_dev, gen, self.dev)  # [3, 2, k+1, N]
        dec = sk.decrypt(cts, self.dev)
        assert_noise_distribution(
            dec.ravel(), pts.ravel(), std, 32, seed=rep_seed * 11 + 9)


class GgswEncryptionFixture(Fixture):
    """GGSW constant encryption: the body rows of each level matrix encrypt
    m * q/B^(j+1) with the configured noise (ggsw_ciphertext_encryption
    fixture analog)."""

    name = "ggsw_encrypt"
    PARAMETERS = [{"k": 1, "N": 64, "base_log": 7, "levels": 3},
                  {"k": 2, "N": 64, "base_log": 6, "levels": 2}]
    SAMPLE_SIZE = 64

    def run_one(self, params, rep_seed):
        from .core.ggsw import encrypt_constant_ggsw

        k, N, bl, lv = params["k"], params["N"], params["base_log"], params["levels"]
        sk = glwe_mod.GlweSecretKey.generate_binary(
            k, N, SecretRandomGenerator(rep_seed))
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        std = StandardDev(2.0 ** -25)
        m = 1
        reps = max(1, self.SAMPLE_SIZE // (lv * N))
        body_dec, body_want = [], []
        for r in range(reps):
            ggsw = encrypt_constant_ggsw(sk, m, bl, lv, std.std_dev, gen,
                                         device=self.dev)
            # ggsw: [levels, k+1, k+1, N]; the last row of level j is a GLWE
            # of m * q/B^(j+1) in coefficient 0
            for j in range(lv):
                body = ggsw[j, k]                      # [k+1, N] GLWE
                dec = sk.decrypt(np.asarray(body)[None], self.dev)[0]
                want = np.zeros(N, dtype=np.uint32)
                want[0] = np.uint32((m << (32 - bl * (j + 1))) % (1 << 32))
                body_dec.append(dec)
                body_want.append(want)
        assert_noise_distribution(
            np.concatenate(body_dec), np.concatenate(body_want), std, 32,
            seed=rep_seed * 7 + 3)


class GswExternalProductFixture(Fixture):
    """Scalar GSW external product selects m * ct exactly on trivial-noise
    operands and within noise bounds otherwise (gsw/tests.rs analog)."""

    name = "gsw_external_product"
    PARAMETERS = [{"dim": 32, "base_log": 8, "levels": 3}]
    SAMPLE_SIZE = 32

    def run_one(self, params, rep_seed):
        from .core import gsw

        sk = lwe_mod.LweSecretKey.generate_binary(
            params["dim"], SecretRandomGenerator(rep_seed))
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        rng = np.random.default_rng(rep_seed)
        for bit in (0, 1):
            g = gsw.encrypt_constant_gsw(
                sk, bit, params["base_log"], params["levels"], 2.0 ** -25, gen)
            pts = rng.integers(0, 1 << 32, size=self.SAMPLE_SIZE, dtype=np.uint32)
            cts = sk.encrypt(pts, 2.0 ** -20, gen)
            out = to_numpy(gsw.external_product(
                g, from_numpy(cts, self.dev),
                base_log=params["base_log"], level_count=params["levels"]))
            dec = sk.decrypt(out)
            want = pts if bit else np.zeros_like(pts)
            predicted = npe.estimate_external_product_noise_with_ggsw_message(
                1, params["dim"], StandardDev(2.0 ** -20), StandardDev(2.0 ** -25),
                params["base_log"], params["levels"], 32,
                msg_mean=float(bit), msg_second_moment=float(bit))
            assert_noise_bounded(dec, want, predicted, 32, slack_bits=1.0)


class LweAddFixture(Fixture):
    """ct1 + ct2 phase = pt1 + pt2 with variance var1 + var2 (KS test;
    lwe_ciphertext_add fixture analog)."""

    name = "lwe_add"
    PARAMETERS = [{"dim": 128, "log_std": -18, "bits": 32}]

    def run_one(self, params, rep_seed):
        bits = params["bits"]
        sk = lwe_mod.LweSecretKey.generate_binary(
            params["dim"], SecretRandomGenerator(rep_seed), bits)
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        std = StandardDev(2.0 ** params["log_std"])
        rng = np.random.default_rng(rep_seed)
        p1 = rng.integers(0, 1 << 32, size=self.SAMPLE_SIZE, dtype=np.uint32)
        p2 = rng.integers(0, 1 << 32, size=self.SAMPLE_SIZE, dtype=np.uint32)
        out = to_numpy(lwe_mod.add(
            from_numpy(sk.encrypt(p1, std.std_dev, gen), self.dev),
            from_numpy(sk.encrypt(p2, std.std_dev, gen), self.dev)))
        with np.errstate(over="ignore"):
            want = (p1 + p2).astype(np.uint32)
        predicted = npe.estimate_addition_noise(
            Variance(std.get_variance()), Variance(std.get_variance()), bits)
        assert_noise_distribution(
            sk.decrypt(out), want,
            StandardDev(predicted.get_standard_dev()), bits, seed=rep_seed * 3 + 11)


class LweSubOppositeFixture(Fixture):
    """Subtraction and negation: phases track exactly, noise adds
    (lwe_ciphertext_opposite / sub fixture analogs)."""

    name = "lwe_sub_opposite"
    PARAMETERS = [{"dim": 128, "log_std": -18}]

    def run_one(self, params, rep_seed):
        sk = lwe_mod.LweSecretKey.generate_binary(
            params["dim"], SecretRandomGenerator(rep_seed))
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        std = StandardDev(2.0 ** params["log_std"])
        rng = np.random.default_rng(rep_seed)
        p1 = rng.integers(0, 1 << 32, size=self.SAMPLE_SIZE, dtype=np.uint32)
        p2 = rng.integers(0, 1 << 32, size=self.SAMPLE_SIZE, dtype=np.uint32)
        c1 = sk.encrypt(p1, std.std_dev, gen)
        c2 = sk.encrypt(p2, std.std_dev, gen)
        with np.errstate(over="ignore"):
            sub_want = (p1 - p2).astype(np.uint32)
            neg_want = (np.uint32(0) - p1).astype(np.uint32)
        c1, c2 = from_numpy(c1, self.dev), from_numpy(c2, self.dev)
        sub_out = to_numpy(lwe_mod.sub(c1, c2))
        predicted = npe.estimate_addition_noise(
            Variance(std.get_variance()), Variance(std.get_variance()), 32)
        assert_noise_bounded(sk.decrypt(sub_out), sub_want, predicted, 32,
                             slack_bits=0.5)
        neg_out = to_numpy(lwe_mod.neg(c1))
        assert_noise_bounded(sk.decrypt(neg_out), neg_want,
                             Variance(std.get_variance()), 32, slack_bits=0.5)


class LwePlaintextArithFixture(Fixture):
    """Plaintext add/sub shift the phase exactly; noise unchanged
    (lwe_ciphertext_plaintext_add/sub fixtures)."""

    name = "lwe_plaintext_arith"
    PARAMETERS = [{"dim": 128, "log_std": -18, "bits": 32},
                  {"dim": 64, "log_std": -30, "bits": 64}]

    def run_one(self, params, rep_seed):
        bits = params["bits"]
        dt = np.uint64 if bits == 64 else np.uint32
        sk = lwe_mod.LweSecretKey.generate_binary(
            params["dim"], SecretRandomGenerator(rep_seed), bits)
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        std = StandardDev(2.0 ** params["log_std"])
        rng = np.random.default_rng(rep_seed)
        pts = rng.integers(0, 1 << 32, size=self.SAMPLE_SIZE, dtype=np.uint32).astype(dt)
        delta = dt(rng.integers(1, 1 << 31))
        cts = sk.encrypt(pts, std.std_dev, gen)
        base = sk.decrypt(cts)
        with np.errstate(over="ignore"):
            ct_dev = from_numpy(cts, self.dev)
            add_out = sk.decrypt(to_numpy(lwe_mod.add_plaintext(ct_dev, delta)))
            sub_out = sk.decrypt(to_numpy(lwe_mod.sub_plaintext(ct_dev, delta)))
            np.testing.assert_array_equal(add_out, (base + delta).astype(dt))
            np.testing.assert_array_equal(sub_out, (base - delta).astype(dt))


class LweCleartextMulFixture(Fixture):
    """Cleartext multiplication: phase scales exactly, noise scales by c
    (lwe_ciphertext_cleartext_mul fixture)."""

    name = "lwe_cleartext_mul"
    PARAMETERS = [{"dim": 128, "log_std": -20, "c": 5}]

    def run_one(self, params, rep_seed):
        sk = lwe_mod.LweSecretKey.generate_binary(
            params["dim"], SecretRandomGenerator(rep_seed))
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        std = StandardDev(2.0 ** params["log_std"])
        rng = np.random.default_rng(rep_seed)
        pts = rng.integers(0, 1 << 32, size=self.SAMPLE_SIZE, dtype=np.uint32)
        cts = sk.encrypt(pts, std.std_dev, gen)
        c = params["c"]
        out = to_numpy(lwe_mod.scalar_mul(from_numpy(cts, self.dev), np.uint32(c)))
        with np.errstate(over="ignore"):
            want = (pts * np.uint32(c)).astype(np.uint32)
        predicted = npe.estimate_integer_plaintext_multiplication_noise(
            Variance(std.get_variance()), c)
        assert_noise_distribution(
            sk.decrypt(out), want, StandardDev(predicted.get_standard_dev()),
            32, seed=rep_seed * 29 + 1)


class PackingKeyswitchBatchFixture(Fixture):
    """Batch packing: a list of LWEs lands in ONE GLWE, coefficient i from
    LWE i, each within the keyswitch noise bound
    (packing_keyswitch_ciphertext_vector fixture analog)."""

    name = "packing_keyswitch_batch"
    PARAMETERS = [{"n_in": 32, "k": 1, "N": 64, "base_log": 6, "levels": 4}]
    SAMPLE_SIZE = 64

    def run_one(self, params, rep_seed):
        from .core import packing
        from .core.lwe import LweSecretKey

        sgen = SecretRandomGenerator(rep_seed)
        lwe_sk = LweSecretKey.generate_binary(params["n_in"], sgen)
        glwe_sk = glwe_mod.GlweSecretKey.generate_binary(params["k"], params["N"], sgen)
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        ks_std = StandardDev(2.0 ** -25)
        ct_std = StandardDev(2.0 ** -20)
        pksk = packing.PackingKeyswitchKey.generate(
            lwe_sk, glwe_sk, params["base_log"], params["levels"], ks_std.std_dev, gen)
        rng = np.random.default_rng(rep_seed)
        m = params["N"] // 2                       # partial fill
        pts = rng.integers(0, 1 << 32, size=m, dtype=np.uint32)
        cts = lwe_sk.encrypt(pts, ct_std.std_dev, gen)
        out = to_numpy(packing.packing_keyswitch(
            pksk.data, from_numpy(cts, self.dev),
            base_log=params["base_log"], level_count=params["levels"]))
        dec = glwe_sk.decrypt(out[None], self.dev)[0][:m]
        # every output coefficient sums the keyswitch noise of ALL m inputs
        # (each input lands as X^i * KS(LWE_i) and the GLWEs are added)
        per_input = npe.estimate_keyswitch_noise_with_constant_terms(
            params["n_in"], ct_std, ks_std, params["base_log"], params["levels"], 32)
        predicted = Variance(per_input.get_variance() * m)
        assert_noise_bounded(dec, pts, predicted, 32, slack_bits=0.5)


class GlweNttConversionFixture(Fixture):
    """GLWE coefficient <-> NTT domain round trip is exact — the std<->Fourier
    conversion fixture analog (conversion engines)."""

    name = "glwe_ntt_conversion"
    PARAMETERS = [{"k": 1, "N": 64, "bits": 32}, {"k": 2, "N": 128, "bits": 32},
                  {"k": 1, "N": 64, "bits": 64}]

    def run_one(self, params, rep_seed):
        cfg = bs.ServerConfig(
            lwe_dimension=8, glwe_dimension=params["k"],
            polynomial_size=params["N"], pbs_base_log=6, pbs_level=2,
            ks_base_log=2, ks_level=5, bits=params["bits"])
        rng = np.random.default_rng(rep_seed)
        dt = np.uint64 if params["bits"] == 64 else np.uint32
        ct = rng.integers(0, 1 << 32, size=(3, params["k"] + 1, params["N"]),
                          dtype=np.uint32).astype(dt)
        spec = glwe_mod.glwe_to_ntt(ct, cfg.primes, params["bits"],
                                    device=self.dev)
        back = glwe_mod.glwe_from_ntt(spec, cfg.primes, params["bits"])
        np.testing.assert_array_equal(to_numpy(back), ct)


class BskConversionCrossBackendFixture(Fixture):
    """BSK standard -> NTT and standard -> MXU-rings conversions agree: the
    external products they feed are bit-identical (the Fourier-conversion
    fixture analog, checked at the op level since both domains are exact)."""

    name = "bsk_conversion_cross_backend"
    PARAMETERS = [{"k": 1, "N": 64, "base_log": 7, "levels": 2}]
    SAMPLE_SIZE = 16

    def run_one(self, params, rep_seed):
        from .core.ggsw import encrypt_constant_ggsw, ggsw_to_ntt

        cfg = bs.ServerConfig(
            lwe_dimension=8, glwe_dimension=params["k"],
            polynomial_size=params["N"], pbs_base_log=params["base_log"],
            pbs_level=params["levels"], ks_base_log=2, ks_level=5)
        sk = glwe_mod.GlweSecretKey.generate_binary(
            params["k"], params["N"], SecretRandomGenerator(rep_seed))
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        ggsw = encrypt_constant_ggsw(
            sk, 1, params["base_log"], params["levels"], 2.0 ** -25, gen,
            device=self.dev)
        rng = np.random.default_rng(rep_seed)
        cts = rng.integers(0, 1 << 32,
                           size=(self.SAMPLE_SIZE, params["k"] + 1, params["N"]),
                           dtype=np.uint32)
        out_ntt = to_numpy(bsntt.external_product(
            cfg, ggsw_to_ntt(ggsw, cfg.primes, 32, device=self.dev),
            from_numpy(cts, self.dev)))
        rings = _rings_mxu(ggsw[None], cfg, self.dev)[0]
        out_mxu = to_numpy(bsx.external_product_mxu(cfg, rings, cts))
        np.testing.assert_array_equal(out_ntt, out_mxu)


class LweKeyDistributionsFixture(Fixture):
    """Encrypt/decrypt under ternary, gaussian, and uniform keys — the
    reference's per-key-kind fixture instantiations (BinaryKeyKind/... markers)."""

    name = "lwe_key_distributions"
    PARAMETERS = [{"dim": 96, "log_std": -17}]

    def run_one(self, params, rep_seed):
        gen_makers = [
            lwe_mod.LweSecretKey.generate_ternary,
            lwe_mod.LweSecretKey.generate_gaussian,
            lwe_mod.LweSecretKey.generate_uniform,
        ]
        std = StandardDev(2.0 ** params["log_std"])
        rng = np.random.default_rng(rep_seed)
        for i, maker in enumerate(gen_makers):
            sk = maker(params["dim"], SecretRandomGenerator(rep_seed + i))
            gen = EncryptionRandomGenerator(rep_seed + 10 + i, rep_seed + 20 + i)
            pts = rng.integers(0, 1 << 32, size=self.SAMPLE_SIZE, dtype=np.uint32)
            cts = sk.encrypt(pts, std.std_dev, gen)
            assert_noise_distribution(
                sk.decrypt(cts), pts, std, 32, seed=rep_seed * 5 + i)


class ModulusSwitchFixture(Fixture):
    """pbs_modulus_switch rounding error within the NPE modswitch bound."""

    name = "modulus_switch"
    PARAMETERS = [{"N": 128, "dim": 64}, {"N": 1024, "dim": 128}]

    def run_one(self, params, rep_seed):
        N, dim = params["N"], params["dim"]
        rng = np.random.default_rng(rep_seed)
        vals = rng.integers(0, 1 << 32, size=(self.SAMPLE_SIZE, dim + 1),
                            dtype=np.uint32)
        switched = bs.pbs_modulus_switch(
            from_numpy(vals, self.dev), N, 0, 0).cpu().numpy()
        # each element maps to the nearest multiple of 2^32/2N: |err| <= half
        back = (switched.astype(np.uint64) << np.uint64(32 - 1 - int(np.log2(N)))) \
            .astype(np.uint32)
        with np.errstate(over="ignore"):
            err = (vals - back).astype(np.int32).astype(np.float64)
        half_step = 2.0 ** 32 / (2 * N) / 2
        assert np.abs(err).max() <= half_step + 1, np.abs(err).max()


class MultiLutPbsFixture(Fixture):
    """Multi-LUT PBS: 2^lcl functions of one input from ONE blind rotation,
    each track within the standard PBS noise bound (LutCountLog machinery)."""

    name = "multi_lut_pbs"
    PARAMETERS = [{"n": 12, "k": 1, "N": 128, "base_log": 8, "levels": 2,
                   "lcl": 1}]
    SAMPLE_SIZE = 16

    def run_one(self, params, rep_seed):
        cfg = bs.ServerConfig(
            lwe_dimension=params["n"], glwe_dimension=params["k"],
            polynomial_size=params["N"], pbs_base_log=params["base_log"],
            pbs_level=params["levels"], ks_base_log=2, ks_level=5)
        sgen = SecretRandomGenerator(rep_seed)
        lwe_sk = lwe_mod.LweSecretKey.generate_binary(params["n"], sgen)
        glwe_sk = glwe_mod.GlweSecretKey.generate_binary(
            params["k"], params["N"], sgen)
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        bsk_std = StandardDev(2.0 ** -25)
        bsk = StandardBootstrapKey.generate(
            lwe_sk, glwe_sk, params["base_log"], params["levels"],
            bsk_std.std_dev, gen, device=self.dev)
        bsk_ntt = bsk_to_ntt(bsk.data, cfg.primes, 32, device=self.dev)
        lcl = params["lcl"]
        eighth = np.uint32(1 << 29)
        neg_eighth = np.uint32((-(1 << 29)) % (1 << 32))
        rng = np.random.default_rng(rep_seed)
        signs = rng.integers(0, 2, size=self.SAMPLE_SIZE).astype(bool)
        msgs = np.where(signs, eighth, neg_eighth)
        cts = lwe_sk.encrypt(msgs, 2.0 ** -20, gen)
        # track t holds constant (t+1)/8
        N = params["N"]
        lut = np.zeros(N, dtype=np.uint32)
        for t in range(1 << lcl):
            lut[t::1 << lcl] = np.uint32((t + 1) << 29)
        acc = np.zeros((params["k"] + 1, N), dtype=np.uint32)
        acc[-1] = lut
        outs = to_numpy(bsntt.bootstrap_many_lut(
            cfg, bsk_ntt, from_numpy(acc, self.dev), from_numpy(cts, self.dev),
            lcl))
        big = glwe_sk.into_lwe_key()
        predicted = npe.estimate_pbs_noise(
            params["n"], N, params["k"], params["base_log"],
            params["levels"], bsk_std, 32)
        for t in range(1 << lcl):
            dec = big.decrypt(outs[t])
            want_mag = np.uint32((t + 1) << 29)
            want = np.where(signs, want_mag,
                            (np.uint32(0) - want_mag).astype(np.uint32))
            assert_noise_bounded(dec, want, predicted, 32, slack_bits=1.0)


class U64KeyswitchFixture(Fixture):
    """u64-torus keyswitch within the NPE bound (Precision64 keyswitch)."""

    name = "lwe_keyswitch_u64"
    PARAMETERS = [{"n_in": 64, "n_out": 32, "base_log": 4, "levels": 5}]

    def run_one(self, params, rep_seed):
        sgen = SecretRandomGenerator(rep_seed)
        in_key = lwe_mod.LweSecretKey.generate_binary(params["n_in"], sgen, 64)
        out_key = lwe_mod.LweSecretKey.generate_binary(params["n_out"], sgen, 64)
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        ks_std = StandardDev(2.0 ** -40)
        ct_std = StandardDev(2.0 ** -35)
        ksk = lwe_mod.LweKeyswitchKey.generate(
            in_key, out_key, params["base_log"], params["levels"],
            ks_std.std_dev, gen)
        rng = np.random.default_rng(rep_seed)
        pts = (rng.integers(0, 1 << 32, size=self.SAMPLE_SIZE, dtype=np.uint32)
               .astype(np.uint64) << np.uint64(32))
        cts = in_key.encrypt(pts, ct_std.std_dev, gen)
        out = to_numpy(lwe_mod.keyswitch(
            ksk.data, from_numpy(cts, self.dev),
            base_log=params["base_log"], level_count=params["levels"]))
        predicted = npe.estimate_keyswitch_noise_with_constant_terms(
            params["n_in"], ct_std, ks_std, params["base_log"],
            params["levels"], 64)
        assert_noise_bounded(out_key.decrypt(out), pts, predicted, 64,
                             slack_bits=0.5)


class GlweArithFixture(Fixture):
    """GLWE add/sub: polynomials add exactly, noise adds (glwe arithmetic
    fixture analog; wrapping tensor arith on ciphertext arrays)."""

    name = "glwe_arith"
    PARAMETERS = [{"k": 1, "N": 64, "log_std": -20}]

    def run_one(self, params, rep_seed):
        sk = glwe_mod.GlweSecretKey.generate_binary(
            params["k"], params["N"], SecretRandomGenerator(rep_seed))
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        std = StandardDev(2.0 ** params["log_std"])
        rng = np.random.default_rng(rep_seed)
        m1 = rng.integers(0, 1 << 32, size=(4, params["N"]), dtype=np.uint32)
        m2 = rng.integers(0, 1 << 32, size=(4, params["N"]), dtype=np.uint32)
        c1 = sk.encrypt(m1, std.std_dev, gen, self.dev)
        c2 = sk.encrypt(m2, std.std_dev, gen, self.dev)
        with np.errstate(over="ignore"):
            add_dec = sk.decrypt((c1 + c2).astype(np.uint32), self.dev)
            want = (m1 + m2).astype(np.uint32)
        predicted = npe.estimate_addition_noise(
            Variance(std.get_variance()), Variance(std.get_variance()), 32)
        assert_noise_bounded(add_dec.ravel(), want.ravel(), predicted, 32,
                             slack_bits=0.5)


class MxuTruncationNoiseFixture(Fixture):
    """Reduced-precision (limb-drop) blind-rotate noise matches the key-
    amplified truncation model — the phase error of the drop-d path vs the
    exact path must sit within the estimate_mxu_truncation_noise bound
    (which includes the (1 + kN*E[s^2]) mask-convolution amplification;
    without it the bound is ~ sqrt(1+kN/2) too small and this fixture
    fails)."""

    name = "mxu_truncation_noise"
    # N >= 256: concrete_tpu validated the (1 + kN*E[s^2]) amplification
    # model at N in {256, 1024}; below that, small-N correlation effects add
    # up to ~1.6x in std (not modeled: no production parameter set uses
    # N < 256 with limb drops)
    PARAMETERS = [
        {"n": 16, "k": 1, "N": 256, "base_log": 7, "levels": 2, "drop": 1},
        {"n": 12, "k": 1, "N": 256, "base_log": 7, "levels": 2, "drop": 2},
    ]
    SAMPLE_SIZE = 32

    def run_one(self, params, rep_seed):
        n, k, N = params["n"], params["k"], params["N"]
        bl, lv, drop = params["base_log"], params["levels"], params["drop"]
        cfg = bs.ServerConfig(
            lwe_dimension=n, glwe_dimension=k, polynomial_size=N,
            pbs_base_log=bl, pbs_level=lv, ks_base_log=4, ks_level=3)
        sgen = SecretRandomGenerator(rep_seed)
        lsk = lwe_mod.LweSecretKey.generate_binary(n, sgen)
        gsk = glwe_mod.GlweSecretKey.generate_binary(k, N, sgen)
        gen = EncryptionRandomGenerator(rep_seed + 1, rep_seed + 2)
        bsk = StandardBootstrapKey.generate(lsk, gsk, bl, lv, 2.0 ** -25, gen,
                                            device=self.dev)
        rng = np.random.default_rng(rep_seed)
        cts = from_numpy(rng.integers(
            0, 1 << 32, size=(self.SAMPLE_SIZE, n + 1), dtype=np.uint32),
            self.dev)
        lut = bs.trivial_lut_constant(cfg, np.uint32(1 << 29), self.dev)
        rings = _rings_mxu(bsk.data, cfg, self.dev)
        exact = bsx.blind_rotate_mxu(cfg, rings, lut, cts)
        # `primes` is a derived property of the port's ServerConfig, not a
        # field to reset (concrete_tpu passes primes=() here)
        fcfg = dataclasses.replace(cfg, mxu_limb_drop=drop)
        fast = bsx.blind_rotate_mxu(fcfg, rings, lut, cts)
        with np.errstate(over="ignore"):
            diff = (gsk.decrypt(fast, self.dev)
                    - gsk.decrypt(exact, self.dev)).astype(np.int32).astype(
                        np.float64)
        return float((diff ** 2).mean()) / 2.0 ** 64

    def stress(self, repetitions=None, sample_size=None, device=None) -> list:
        # POOLED criterion: the amplification model is a KEY-AVERAGE; with
        # only n=16 toeplitz rings the per-key quadratic form in s fluctuates
        # by tens of percent (each ring's rounding error appears in all N
        # rotated rows, so errors are strongly correlated — measured per-rep
        # sigma ratios span 1.0-1.6x while the repetition pool sits at the
        # model). Pool the variance across repetitions, then apply the same
        # sqrt(2)-slack criterion to the pooled sigma.
        self.device = resolve_device(device)
        reps = repetitions or self.REPETITIONS
        if sample_size:
            self.SAMPLE_SIZE = sample_size
        reports = []
        for params in self.PARAMETERS:
            ok, detail = True, ""
            try:
                pool = [self.run_one(params, rep_seed=1000 * rep + 7)
                        for rep in range(reps)]
                predicted = npe.estimate_mxu_truncation_noise(
                    params["n"], params["N"], params["k"],
                    params["base_log"], params["levels"], params["drop"], 32)
                measured = float(np.sqrt(np.mean(pool)))
                bound = predicted.get_standard_dev() * 2.0 ** 0.5
                assert measured <= bound, (
                    f"pooled truncation noise {measured:.3e} exceeds model "
                    f"bound {bound:.3e}")
                # the model must not be wildly conservative either (the
                # point of the fixture is to pin the amplification factor)
                assert measured >= predicted.get_standard_dev() * 0.3, (
                    f"pooled truncation noise {measured:.3e} far below model "
                    f"{predicted.get_standard_dev():.3e} — model regression?")
            except AssertionError as e:
                ok, detail = False, str(e)
            reports.append(FixtureReport(
                self.name, params, reps, self.SAMPLE_SIZE, ok, detail))
        return reports


class CreationRetrievalFixture(Fixture):
    """Entity creation from raw containers and lossless retrieval — the
    analog of the reference's ~20 *_creation / *_retrieval fixture files
    (concrete-core-fixture/src/fixture/: cleartext_*, plaintext_*,
    lwe_ciphertext_creation, glwe_ciphertext_creation, ...). No crypto
    content: every raw value placed into an entity must come back
    bit-identical, across the container types of the user API."""

    name = "creation_retrieval"
    PARAMETERS = [
        {"what": "cleartext_f64"},
        {"what": "plaintext_u64"},
        {"what": "lwe_raw"},
        {"what": "glwe_raw"},
        {"what": "secret_keys"},
    ]
    SAMPLE_SIZE = 64

    def run_one(self, params, rep_seed):
        rng = np.random.default_rng(rep_seed)
        what = params["what"]
        if what == "cleartext_f64":
            # cleartext = unencoded f64 (cleartext_creation/retrieval.rs):
            # the Encoder round-trips reals within its granularity, and the
            # raw torus container round-trips exactly
            from .highlevel import Encoder

            enc = Encoder.new(-4.0, 4.0, nb_bit_precision=8, nb_bit_padding=2)
            msgs = rng.uniform(-4.0, 4.0, self.SAMPLE_SIZE)
            raw = enc.encode_core(msgs)
            back = enc.decode_core(raw)
            assert np.all(np.abs(back - msgs) <= enc.get_granularity())
        elif what == "plaintext_u64":
            # plaintext_creation/retrieval + vector variants: raw u64 torus
            # values survive the Plaintext container bit-for-bit
            from .highlevel import Encoder, Plaintext

            enc = Encoder.new(0.0, 1.0, 4, 1)
            pts = rng.integers(0, 1 << 63, self.SAMPLE_SIZE, dtype=np.uint64)
            p = Plaintext(plaintexts=pts.copy(),
                          encoders=[enc.copy() for _ in pts])
            assert np.array_equal(p.plaintexts, pts)
            p.set_nth_encoder(0, Encoder.new(0.0, 2.0, 4, 1))
            assert np.array_equal(p.plaintexts, pts)  # encoders independent
        elif what == "lwe_raw":
            # lwe_ciphertext_creation (from container) + encrypt_raw /
            # decrypt_raw round trip under a NOISELESS path is exact
            from .highlevel import LWE, LWESecretKey
            from .highlevel.params_presets import LWEParams

            sk = LWESecretKey.new(LWEParams(64, -62), secret_seed=rep_seed)
            pts = rng.integers(0, 1 << 64, self.SAMPLE_SIZE, dtype=np.uint64)
            ct = LWE.encrypt_raw(sk, pts, mask_seed=rep_seed + 1,
                                 noise_seed=rep_seed + 2)
            back = np.asarray(ct.decrypt_raw(sk), dtype=np.uint64)
            # noise at 2^-62 rounds away only the lowest bits
            diff = (back - pts).astype(np.int64)
            assert np.all(np.abs(diff) < (1 << 8)), np.abs(diff).max()
        elif what == "glwe_raw":
            # glwe_ciphertext_creation: raw coefficient containers round
            # trip through the VectorRLWE entity unchanged
            from .highlevel import VectorRLWE

            data = rng.integers(0, 1 << 64, size=(3, 2, 64), dtype=np.uint64)
            v = VectorRLWE.zero(64, 1, 3)
            v.data[:] = data
            assert np.array_equal(v.data, data)
            assert v.nb_valid() == 0  # zero() slots are invalid encoders
        elif what == "secret_keys":
            # lwe/glwe_secret_key_creation: generated key bits retrieve
            # losslessly through save/load (binary containers)
            import os
            import tempfile

            from .highlevel import LWESecretKey, RLWESecretKey
            from .highlevel.params_presets import LWEParams, RLWEParams

            sk = LWESecretKey.new(LWEParams(64, -20), secret_seed=rep_seed)
            rsk = RLWESecretKey.new(RLWEParams(64, 2, -20),
                                    secret_seed=rep_seed + 1)
            with tempfile.TemporaryDirectory() as d:
                sk.save(os.path.join(d, "sk.npz"))
                rsk.save(os.path.join(d, "rsk.npz"))
                sk2 = LWESecretKey.load(os.path.join(d, "sk.npz"))
                rsk2 = RLWESecretKey.load(os.path.join(d, "rsk.npz"))
            assert np.array_equal(sk.inner.key, sk2.inner.key)
            assert np.array_equal(rsk.inner.key, rsk2.inner.key)
            assert sk.std_dev == sk2.std_dev
            flat = rsk.to_lwe_secret_key()
            assert flat.dimension == 128
        else:  # pragma: no cover
            raise ValueError(what)



ALL_FIXTURES = [
    LweEncryptDecryptFixture,
    GlweEncryptDecryptFixture,
    LweKeyswitchFixture,
    ExternalProductFixture,
    PackingKeyswitchFixture,
    LweAffineTransformFixture,
    SampleExtractFixture,
    CmuxFixture,
    PbsFixture,
    U64PbsFixture,
    LweTrivialEncryptFixture,
    GlweTrivialEncryptFixture,
    LweListEncryptFixture,
    GlweListEncryptFixture,
    GgswEncryptionFixture,
    GswExternalProductFixture,
    LweAddFixture,
    LweSubOppositeFixture,
    LwePlaintextArithFixture,
    LweCleartextMulFixture,
    PackingKeyswitchBatchFixture,
    GlweNttConversionFixture,
    BskConversionCrossBackendFixture,
    LweKeyDistributionsFixture,
    ModulusSwitchFixture,
    MultiLutPbsFixture,
    U64KeyswitchFixture,
    GlweArithFixture,
    MxuTruncationNoiseFixture,
    CreationRetrievalFixture,
]


def run_all(repetitions=None, sample_size=None, device=None) -> list:
    """Every fixture's reports, in ALL_FIXTURES' order; the server-side ops
    on `device` (None: the GPU)."""
    device = resolve_device(device)
    reports = []
    for fx_cls in ALL_FIXTURES:
        reports.extend(fx_cls().stress(repetitions, sample_size, device))
    return reports
