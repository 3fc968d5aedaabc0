"""High-level key types: secret keys, bootstrapping and keyswitching keys
(concrete/src/{lwe_secretkey,rlwe_secretkey,lwe_bsk,lwe_ksk}.rs), on the
u64 torus.

Secret keys live on the host as np.uint64. The bootstrapping and
keyswitching keys keep their coefficient-domain arrays on the host and
derive their evaluation forms (toeplitz or Nussbaumer rings, NTT spectra,
int8 limb planes) on `device` at first use: the GPU unless the caller asks for the
CPU. Key generation draws from the AES-CTR streams, so equal seeds give
concrete_tpu's keys byte for byte (the BSK's products run on `device`);
keys saved by concrete_tpu load here unchanged (`load`). The run_* calls
put their host inputs on the device in the span `highlevel.to_device`
(ops/graphs.span: recorded under a torch.profiler session).

Example (a tiny PBS + keyswitch on the CPU):
    >>> import numpy as np
    >>> from concrete_tpu_torch.highlevel import LWEParams, RLWEParams
    >>> sk = LWESecretKey.new(LWEParams(16, -40), secret_seed=1)
    >>> rsk = RLWESecretKey.new(RLWEParams(256, 1, -50), secret_seed=2)
    >>> bsk = LWEBSK.new(sk, rsk, 7, 3, mask_seed=3, noise_seed=4, device="cpu")
    >>> bsk.resolved_backend(), bsk.with_fast_mode().cfg.mxu_limb_drop
    ('mxu', 2)
    >>> ksk = LWEKSK.new(rsk.to_lwe_secret_key(), sk, 2, 8, mask_seed=5,
    ...                  noise_seed=6, device="cpu")
    >>> ksk.run_keyswitch(np.zeros((3, 257), np.uint64)).shape
    torch.Size([3, 17])
    >>> sk.inner.key[:8].tolist()
    [0, 0, 0, 1, 1, 1, 0, 1]
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import npe
from ..core import bootstrap as bs
from ..core import lwe as lwe_ops
from ..core.backends import BACKENDS, EvaluationForms, EvaluationKey
from ..core.ggsw import StandardBootstrapKey
from ..core.glwe import GlweSecretKey
from ..core.lwe import LweKeyswitchKey, LweSecretKey
from ..csprng import EncryptionRandomGenerator, SecretRandomGenerator
from ..dispersion import Variance
from ..ops import graphs
from ..ops._cuda import resolve_device
from ..params import log2_exact
from ..torus import as_torus
from .encoder import BITS, DTYPE
from .params_presets import LWEParams, RLWEParams


@dataclasses.dataclass
class LWESecretKey:
    """u64 binary LWE secret key + its noise parameter (lwe_secretkey.rs)."""

    inner: LweSecretKey
    std_dev: float

    @classmethod
    def new(cls, params: LWEParams, *, secret_seed: int | None = None):
        gen = SecretRandomGenerator(secret_seed)
        return cls(LweSecretKey.generate_binary(params.dimension, gen, BITS),
                   params.std_dev)

    @property
    def dimension(self) -> int:
        return self.inner.dimension

    @property
    def variance(self) -> float:
        return self.std_dev ** 2

    def save(self, path: str):
        """Serialize in the npz format of concrete_tpu's LWESecretKey.save."""
        np.savez(path, key=self.inner.key, std_dev=self.std_dev, kind="binary")

    @classmethod
    def load(cls, path: str) -> "LWESecretKey":
        with np.load(path, allow_pickle=False) as d:
            return cls(LweSecretKey(d["key"].astype(DTYPE), "binary", BITS),
                       float(d["std_dev"]))


@dataclasses.dataclass
class RLWESecretKey:
    """u64 binary GLWE secret key (rlwe_secretkey.rs)."""

    inner: GlweSecretKey
    std_dev: float

    @classmethod
    def new(cls, params: RLWEParams, *, secret_seed: int | None = None):
        gen = SecretRandomGenerator(secret_seed)
        return cls(GlweSecretKey.generate_binary(
            params.dimension, params.polynomial_size, gen, BITS), params.std_dev)

    @property
    def dimension(self) -> int:
        return self.inner.dimension

    @property
    def polynomial_size(self) -> int:
        return self.inner.polynomial_size

    @property
    def variance(self) -> float:
        return self.std_dev ** 2

    def to_lwe_secret_key(self) -> LWESecretKey:
        """Flatten to the big LWE key of dimension k*N."""
        return LWESecretKey(self.inner.into_lwe_key(), self.std_dev)

    def save(self, path: str):
        """Serialize in the npz format of concrete_tpu's RLWESecretKey.save."""
        np.savez(path, key=self.inner.key, std_dev=self.std_dev, kind="binary")

    @classmethod
    def load(cls, path: str) -> "RLWESecretKey":
        with np.load(path, allow_pickle=False) as d:
            return cls(GlweSecretKey(d["key"].astype(DTYPE), "binary", BITS),
                       float(d["std_dev"]))


@dataclasses.dataclass
class LWEBSK(EvaluationForms):
    """Bootstrapping key (lwe_bsk.rs:20): GGSW encryptions of the input key
    bits under the RLWE key, [n, l, k+1, k+1, N] np.uint64. The rings of the
    mxu (N <= 4096) or nuss (N = 8192, 16384) backend, or the spectra of the
    ntt backend, are built on `device` at first use.

    run_bootstrap and run_bootstrap_many replay one captured CUDA graph per
    signature on the card (ops/graphs.py): concrete_tpu runs each blind
    rotation as one compiled lax.scan, so its CMux loop reaches the device
    as one program; here the whole PBS does. The forms, the graphs and
    their pool live in `evaluation` (core/backends.py), made anew with
    every key, so a key made from another's fields (dataclasses.replace,
    with_fast_mode, load) has its own."""

    cfg: bs.ServerConfig
    variance: float
    coefficient_bsk: np.ndarray
    device: torch.device | str | None = None   # None: the GPU (required)
    backend: str = "auto"
    evaluation: EvaluationKey = dataclasses.field(
        init=False, repr=False, compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.evaluation = EvaluationKey(self.cfg, self.coefficient_bsk,
                                        self.device, self.backend)

    def with_fast_mode(self, *, limb_drop: int = 2,
                       levels: int | None = None) -> "LWEBSK":
        """Reduced-precision evaluation twin over the same key material
        (concrete_tpu's LWEBSK.with_fast_mode): ``limb_drop`` of the 8
        bootstrap-key byte limbs are dropped on the mxu backend (the nuss
        and ntt backends are exact and ignore it, as in concrete_tpu), ``levels``
        keeps only the most significant PBS decomposition levels. The extra
        noise is tracked by bootstrap_output_variance. Ciphertexts and
        client keys are unchanged."""
        cfg = self.cfg.with_fast_mode(limb_drop=limb_drop, levels=levels)
        return dataclasses.replace(
            self, cfg=cfg,
            coefficient_bsk=self.coefficient_bsk[:, :cfg.pbs_level])

    def bootstrap_output_variance(self, lwe_dimension: int) -> float:
        """PBS output variance, with the reduced-precision term in fast
        mode on the mxu backend."""
        var = npe.estimate_pbs_noise(
            lwe_dimension, self.polynomial_size, self.dimension,
            self.base_log, self.level, Variance(self.variance), BITS,
        ).get_variance()
        drop = self.cfg.mxu_limb_drop
        if drop and self.resolved_backend() == "mxu":
            var += npe.estimate_mxu_truncation_noise(
                lwe_dimension, self.polynomial_size, self.dimension,
                self.base_log, self.level, drop, BITS,
            ).get_variance()
        return var

    def run_bootstrap(self, accumulator, cts) -> torch.Tensor:
        """PBS of `cts` [..., n+1] against `accumulator` [k+1, N] (u64 numpy
        or int64 tensors) -> [..., k*N+1] int64 on the device, replayed
        from the key's graph of this signature on the card."""
        with graphs.span("highlevel.to_device"):
            acc = as_torus(accumulator, self.device, BITS)
            cts = as_torus(cts, self.device, BITS)
        ev = self.evaluation
        call = ev.graphed(None, lambda: functools.partial(
            BACKENDS[ev.backend].bootstrap, ev.cfg), 1, "pbs")
        return call(ev.form(), acc, cts)

    def run_bootstrap_many(self, accumulator, cts,
                           lut_count_log: int) -> torch.Tensor:
        """Multi-LUT PBS: one blind rotation, 2^lcl packed functions ->
        [2^lcl, ..., k*N+1] int64 on the device (a graph per signature and
        lut_count_log on the card)."""
        with graphs.span("highlevel.to_device"):
            acc = as_torus(accumulator, self.device, BITS)
            cts = as_torus(cts, self.device, BITS)
        ev = self.evaluation
        call = ev.graphed(lut_count_log, lambda: functools.partial(
            BACKENDS[ev.backend].bootstrap_many_lut, ev.cfg,
            lut_count_log=lut_count_log),
            1, f"pbs_many_lut lut_count_log={lut_count_log}")
        return call(ev.form(), acc, cts)

    @classmethod
    def new(cls, sk_input: LWESecretKey, sk_output: RLWESecretKey,
            base_log: int, level: int, *, mask_seed: int | None = None,
            noise_seed: int | None = None, device=None,
            backend: str = "auto") -> "LWEBSK":
        """GGSW-encrypt `sk_input`'s bits under `sk_output`, with masks and
        noise from the AES-CTR streams seeded with `mask_seed`/`noise_seed`
        (concrete_tpu's bytes); the mask-times-key products run on
        `device`."""
        cfg = cls._config(sk_input.dimension, sk_output.dimension,
                          sk_output.polynomial_size, base_log, level)
        device = resolve_device(device)
        std_bsk = StandardBootstrapKey.generate(
            sk_input.inner, sk_output.inner, base_log, level,
            sk_output.std_dev, EncryptionRandomGenerator(mask_seed, noise_seed),
            device=device)
        return cls(cfg=cfg, variance=sk_output.variance,
                   coefficient_bsk=std_bsk.data, device=device, backend=backend)

    @staticmethod
    def _config(n: int, k: int, poly: int, base_log: int,
                level: int) -> bs.ServerConfig:
        return bs.ServerConfig(
            lwe_dimension=n, glwe_dimension=k, polynomial_size=poly,
            pbs_base_log=base_log, pbs_level=level, ks_base_log=1, ks_level=1,
            bits=BITS)

    @property
    def dimension(self) -> int:  # RLWE dimension k
        return self.cfg.glwe_dimension

    @property
    def polynomial_size(self) -> int:
        return self.cfg.polynomial_size

    @property
    def base_log(self) -> int:
        return self.cfg.pbs_base_log

    @property
    def level(self) -> int:
        return self.cfg.pbs_level

    def get_lwe_dimension(self) -> int:
        return self.cfg.lwe_dimension

    def get_polynomial_size_log(self) -> int:
        return log2_exact(self.polynomial_size)

    def save(self, path: str):
        """Serialize in the npz format of concrete_tpu's LWEBSK.save."""
        np.savez_compressed(
            path, bsk=self.coefficient_bsk, variance=self.variance,
            lwe_dimension=self.cfg.lwe_dimension,
            base_log=self.cfg.pbs_base_log, level=self.cfg.pbs_level)

    @classmethod
    def load(cls, path: str, *, device=None, backend: str = "auto") -> "LWEBSK":
        with np.load(path, allow_pickle=False) as d:
            data = d["bsk"].astype(DTYPE)
            _, _, glwe_size, _, poly = data.shape
            cfg = cls._config(int(d["lwe_dimension"]), glwe_size - 1, poly,
                              int(d["base_log"]), int(d["level"]))
            return cls(cfg=cfg, variance=float(d["variance"]),
                       coefficient_bsk=data, device=device, backend=backend)


@dataclasses.dataclass
class LWEKSK:
    """Keyswitching key (lwe_ksk.rs:14). It runs against its int8 limb
    planes (lwe.ksk_to_limbs), built on `device` at first use: one int8
    product where base_log <= 7 and the int32 bound hold (the limb path,
    which concrete_tpu takes on the TPU), the general keyswitch's product
    elsewhere (lwe.keyswitch_prepared), where concrete_tpu runs its u64
    keyswitch; the same bits either way."""

    inner: LweKeyswitchKey
    variance: float
    device: torch.device | str | None = None   # None: the GPU (required)
    _limbs: torch.Tensor | None = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def limbs(self) -> torch.Tensor:
        """int8 limb planes [n_in*l, 8*(n_out+1)] on the device."""
        if self._limbs is None:
            self._limbs = torch.from_numpy(
                lwe_ops.ksk_to_limbs(self.inner.data)).to(self.device)
        return self._limbs

    def run_keyswitch(self, cts) -> torch.Tensor:
        """Keyswitch a [..., n_in+1] batch (u64 numpy or int64 tensor) ->
        [..., n_out+1] int64 on the device."""
        with graphs.span("highlevel.to_device"):
            cts = as_torus(cts, self.device, BITS)
        return lwe_ops.keyswitch_prepared(
            self.limbs, cts, base_log=self.base_log, level_count=self.level)

    @classmethod
    def new(cls, sk_before: LWESecretKey, sk_after: LWESecretKey,
            base_log: int, level: int, *, mask_seed: int | None = None,
            noise_seed: int | None = None, device=None) -> "LWEKSK":
        ksk = LweKeyswitchKey.generate(
            sk_before.inner, sk_after.inner, base_log, level,
            sk_after.std_dev, EncryptionRandomGenerator(mask_seed, noise_seed))
        return cls(inner=ksk, variance=sk_after.variance, device=device)

    @property
    def base_log(self) -> int:
        return self.inner.base_log

    @property
    def level(self) -> int:
        return self.inner.level_count

    def save(self, path: str):
        """Serialize in the npz format of concrete_tpu's LWEKSK.save."""
        np.savez_compressed(
            path, data=self.inner.data, base_log=self.inner.base_log,
            level=self.inner.level_count, variance=self.variance)

    @classmethod
    def load(cls, path: str, *, device=None) -> "LWEKSK":
        with np.load(path, allow_pickle=False) as d:
            return cls(inner=LweKeyswitchKey(
                d["data"].astype(DTYPE), int(d["base_log"]), int(d["level"]),
                BITS), variance=float(d["variance"]), device=device)
