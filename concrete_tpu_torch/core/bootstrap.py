"""Bootstrap building blocks shared by every backend: the static server
configuration, the modulus switch to Z_2N, sample extraction and the
boolean gates' constant test polynomial (crypto/bootstrap/fourier/mod.rs).
The exact-NTT backend itself is core/bootstrap_ntt.py.

u32 torus values ride int32 tensors and u64 ones int64 tensors (see
``concrete_tpu_torch.torus``).

Example (modulus switch to the 2N grid: 1/2 of the torus -> 8 of 16):
    >>> import numpy as np
    >>> from concrete_tpu_torch.torus import from_numpy
    >>> pbs_modulus_switch(from_numpy([1 << 31]), 8).tolist()
    [8]
    >>> pbs_modulus_switch(from_numpy(np.array([1 << 63], np.uint64)), 8).tolist()
    [8]

A reduced-precision view of one configuration (the same keys), and the CRT
primes of the ntt backend, derived from the other fields:
    >>> cfg = ServerConfig(lwe_dimension=8, glwe_dimension=1, polynomial_size=64,
    ...     pbs_base_log=7, pbs_level=3, ks_base_log=2, ks_level=8, bits=64)
    >>> fast = cfg.with_fast_mode(limb_drop=2)
    >>> fast.pbs_level, fast.mxu_limb_drop
    (3, 2)
    >>> len(cfg.primes), len(dataclasses.replace(cfg, bits=32).primes)
    (3, 2)
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..math import crt, ntt, polynomial
from ..params import BooleanParameters
from ..torus import as_torus, bits_of, carrier, lshr


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Static configuration of the server-side ops: the u32 (boolean) or
    u64 (high-level) torus.

    ``mxu_limb_drop`` drops that many low byte limbs of the bootstrap key
    operand of the toeplitz external product: every key coefficient is
    rounded to a multiple of 2^(8 * drop), an unbiased error that enters the
    PBS noise like extra bootstrap-key noise (npe.estimate_mxu_truncation_noise).
    0 is exact."""

    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    bits: int = 32
    mxu_limb_drop: int = 0

    def __post_init__(self):
        if not (0 <= self.mxu_limb_drop <= self.bits // 8 - 2):
            raise ValueError(
                f"mxu_limb_drop={self.mxu_limb_drop}: must keep >= 2 of the "
                f"{self.bits // 8} bootstrap-key byte limbs")

    @classmethod
    def from_boolean_parameters(cls, p: BooleanParameters) -> "ServerConfig":
        return cls(
            lwe_dimension=p.lwe_dimension,
            glwe_dimension=p.glwe_dimension,
            polynomial_size=p.polynomial_size,
            pbs_base_log=p.pbs_base_log,
            pbs_level=p.pbs_level,
            ks_base_log=p.ks_base_log,
            ks_level=p.ks_level,
        )

    def with_fast_mode(self, *, limb_drop: int = 1,
                       levels: int | None = None) -> "ServerConfig":
        """A reduced-precision view over the same key material: ``levels``
        (<= pbs_level) keeps only the most significant decomposition levels
        (the bootstrap key is sliced to match), ``limb_drop`` sets
        mxu_limb_drop. Ciphertexts and client keys are unchanged."""
        lv = self.pbs_level if levels is None else levels
        if not (1 <= lv <= self.pbs_level):
            raise ValueError(f"levels={lv}: need 1 <= levels <= pbs_level")
        return dataclasses.replace(self, pbs_level=lv, mxu_limb_drop=limb_drop)

    @property
    def glwe_size(self) -> int:
        return self.glwe_dimension + 1

    @property
    def big_lwe_dimension(self) -> int:
        return self.glwe_dimension * self.polynomial_size

    @property
    def primes(self) -> tuple[int, ...]:
        """The CRT primes of the ntt backend (concrete_tpu's
        ServerConfig.primes): the smallest prefix of ntt.DEFAULT_PRIMES whose
        product bounds the external product. Raises ValueError or
        NotImplementedError where the ntt backend cannot take the
        configuration, as concrete_tpu's ServerConfig does; the other
        backends still take it."""
        return _ntt_primes(self.polynomial_size,
                           self.pbs_level * self.glwe_size,
                           self.pbs_base_log, self.bits)

    @property
    def crt_context(self) -> crt.CrtContext:
        return crt.CrtContext.new(self.primes, self.bits)

    def plan(self, p: int) -> ntt.NttPlan:
        return ntt.make_plan(self.polynomial_size, p)


@functools.lru_cache(maxsize=None)
def _ntt_primes(n: int, terms: int, base_log: int, bits: int) -> tuple[int, ...]:
    """ServerConfig.primes for N = n, terms = l*(k+1) products a
    coefficient: crt.select_primes of the external-product bound. The ntt
    path maps signed digits to residues with one +p fixup, which needs
    |digit| <= B/2 < min(prime)."""
    primes = crt.select_primes(
        crt.external_product_bound(n, terms, 1 << base_log, bits))
    if (1 << (base_log - 1)) >= min(primes):
        raise NotImplementedError(
            f"pbs_base_log={base_log}: gadget digits exceed the smallest CRT "
            f"prime {min(primes)}")
    return primes


def pbs_modulus_switch(x: torch.Tensor, poly_size: int, offset: int = 0,
                       lut_count_log: int = 0) -> torch.Tensor:
    """Round torus values to Z_2N (fourier/mod.rs:728-748): offset = MSBs
    discarded, lut_count_log = LSB padding for multi-LUT packing. Returns
    int32 degrees in [0, 2N]; 2N, like every degree, acts mod 2N."""
    log2n = poly_size.bit_length() - 1
    out = x << offset
    out = lshr(out, bits_of(x) - log2n - 2 + lut_count_log)
    out = out + (out & 1)
    out = lshr(out, 1)
    return (out << lut_count_log).to(torch.int32)


def sample_extract(glwe: torch.Tensor) -> torch.Tensor:
    """LWE (dimension k*N) of coefficient 0 of the GLWE [..., k+1, N]
    (fourier/mod.rs:750-790): each mask polynomial reversed and negated,
    then multiplied by X; the body is coefficient 0 of the body polynomial."""
    mask = glwe[..., :-1, :]
    rolled = torch.roll(-mask.flip(-1), 1, dims=-1)
    out_mask = torch.cat([-rolled[..., :1], rolled[..., 1:]], dim=-1)
    lead = glwe.shape[:-2]
    out_mask = out_mask.reshape(lead + (mask.shape[-2] * mask.shape[-1],))
    return torch.cat([out_mask, glwe[..., -1, :1]], dim=-1)


def sample_extract_nth(glwe: torch.Tensor, n_th: int) -> torch.Tensor:
    """LWE of coefficient `n_th`: rotate by X^-n_th, then extract."""
    return sample_extract(polynomial.negacyclic_monomial_div(glwe, n_th))


def trivial_lut_constant(cfg: ServerConfig, value, device=None) -> torch.Tensor:
    """Accumulator GLWE [k+1, N] with zero mask and a constant body
    polynomial: the boolean gates' test polynomial (server_key/mod.rs:145-156)."""
    lut = torch.zeros((cfg.glwe_size, cfg.polynomial_size),
                      dtype=carrier(cfg.bits), device=device)
    lut[-1, :] = as_torus(value, device, cfg.bits)
    return lut
