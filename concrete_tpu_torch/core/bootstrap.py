"""Bootstrap building blocks shared by every backend: the static server
configuration, the modulus switch to Z_2N, sample extraction and the
boolean gates' constant test polynomial (crypto/bootstrap/fourier/mod.rs).

u32 torus only; values ride int32 tensors (see ``concrete_tpu_torch.torus``).

Example (modulus switch to the 2N grid: 1/2 of the torus -> 8 of 16):
    >>> import numpy as np
    >>> from concrete_tpu_torch.torus import from_numpy
    >>> pbs_modulus_switch(from_numpy([1 << 31]), 8).tolist()
    [8]
"""

from __future__ import annotations

import dataclasses

import torch

from ..math import polynomial
from ..params import BooleanParameters
from ..torus import as_torus, lshr


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Static configuration of the server-side ops (u32 torus)."""

    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int

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

    @property
    def glwe_size(self) -> int:
        return self.glwe_dimension + 1

    @property
    def big_lwe_dimension(self) -> int:
        return self.glwe_dimension * self.polynomial_size


def pbs_modulus_switch(x: torch.Tensor, poly_size: int, offset: int = 0,
                       lut_count_log: int = 0) -> torch.Tensor:
    """Round torus values to Z_2N (fourier/mod.rs:728-748): offset = MSBs
    discarded, lut_count_log = LSB padding for multi-LUT packing. Returns
    int32 degrees in [0, 2N]; 2N, like every degree, acts mod 2N."""
    log2n = poly_size.bit_length() - 1
    out = x << offset
    out = lshr(out, 32 - log2n - 2 + lut_count_log)
    out = out + (out & 1)
    out = lshr(out, 1)
    return out << lut_count_log


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
    lut = torch.zeros((cfg.glwe_size, cfg.polynomial_size), dtype=torch.int32,
                      device=device)
    lut[-1, :] = as_torus(value, device)
    return lut
