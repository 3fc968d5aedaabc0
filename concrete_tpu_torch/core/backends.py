"""The bootstrap backends in one table, and a key's evaluation side.

`BACKENDS` holds, per backend ("mxu": toeplitz rings, N <= 4096; "nuss":
Nussbaumer rings, N = 8192, 16384; "ntt": NTT spectra, K9 on the u32
torus), the check of a configuration, the bootstrap key's evaluation form
on a device and the PBS functions that take it. The three are
bit-identical. `resolve_backend` is the one place where "auto" is decided.

`EvaluationKey` is what a key evaluates with: the backend, resolved once;
the forms, built on the key's device at first use; the key's captured
graphs (ops/graphs.GraphedCall, one a slot) and their memory pool.
ServerKey and LWEBSK make one whenever they are made, so a key from
`dataclasses.replace`, `with_fast_mode` or `load` has forms and graphs of
its own; `EvaluationKey.to` moves the forms. `EvaluationForms` gives both
keys the public names that read it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from ..ops.graphs import GraphedCall, GraphPool
from ..torus import from_numpy
from . import bootstrap_mxu as bsx
from . import bootstrap_ntt as bsntt
from . import bootstrap_nuss as bsn
from .bootstrap import ServerConfig
from .ggsw import bsk_to_ntt


@dataclasses.dataclass(frozen=True)
class Backend:
    """One bootstrap backend. `check(cfg)` raises where the backend cannot
    take the configuration; `prepare(bsk_standard, cfg, device)` is the
    [n, l, k+1, k+1, N] standard BSK in the backend's evaluation form on
    `device`; the PBS functions take that form:
    bootstrap(cfg, bsk, lut, lwe), bootstrap_many_lut(cfg, bsk, lut, lwe,
    lut_count_log) and bootstrap_keyswitch(cfg, bsk, ksk8, lut, lwe)."""

    check: Callable
    prepare: Callable
    bootstrap: Callable
    bootstrap_many_lut: Callable
    bootstrap_keyswitch: Callable


def _check_ntt(cfg: ServerConfig):
    cfg.primes  # noqa: B018 - raises where the ntt backend cannot take cfg


BACKENDS = {
    "mxu": Backend(
        bsx.MxuPlan.from_config,
        lambda bsk, cfg, device: from_numpy(bsx.bsk_to_mxu(bsk, cfg), device),
        bsx.bootstrap_mxu, bsx.bootstrap_many_lut_mxu,
        bsx.bootstrap_keyswitch_mxu),
    "nuss": Backend(
        bsn.NussPlan.from_config,
        lambda bsk, cfg, device: bsn.bsk_to_nuss(bsk, cfg, device=device),
        bsn.bootstrap_nuss, bsn.bootstrap_many_lut_nuss,
        bsn.bootstrap_keyswitch_nuss),
    "ntt": Backend(
        _check_ntt,
        lambda bsk, cfg, device: bsk_to_ntt(bsk, cfg.primes, cfg.bits,
                                            device=device),
        bsntt.bootstrap, bsntt.bootstrap_many_lut, bsntt.bootstrap_keyswitch),
}


def resolve_backend(cfg: ServerConfig, backend: str) -> str:
    """The bootstrap backend for `cfg`: "mxu", "nuss" or "ntt" when named
    (and the backend takes the configuration), else for "auto", per torus:

    - u32: "ntt" wherever `cfg.primes` takes the configuration, which is
      concrete_tpu's rule off the TPU; else mxu (N <= 4096), then nuss. On
      an H100 80GB HBM3 (700 W) the ntt AND ran 22,015 / 19,526 / 10,904
      gates/s at TPU128 / DEFAULT / TFHE_LIB, B=2048, against mxu's 6,034 /
      2,560 / 1,801, and K9's N=8192 step took 458 us at B=256 against
      ~4.5 ms for a nuss step (chip_smoke.py).
    - u64: mxu up to N = 4096, nuss above, ntt where neither plan takes
      the configuration. This deviates on purpose from concrete_tpu's
      off-TPU rule: the u64 ntt step has no kernel (three primes, a torch
      composition) and ran 24.7-41.9 int4 PBS/s at B=256 against mxu's 825
      at B=2048 on the same card.

    >>> tpu128 = ServerConfig(lwe_dimension=630, glwe_dimension=4,
    ...     polynomial_size=256, pbs_base_log=7, pbs_level=2, ks_base_log=2,
    ...     ks_level=6)
    >>> [resolve_backend(dataclasses.replace(tpu128, bits=b), "auto")
    ...  for b in (32, 64)]
    ['ntt', 'mxu']
    """
    if backend in BACKENDS:
        BACKENDS[backend].check(cfg)
        return backend
    if backend != "auto":
        raise ValueError(f"backend {backend!r}: expected mxu, nuss, ntt or "
                         "auto")
    for name in ("ntt", "mxu", "nuss") if cfg.bits == 32 else ("mxu", "nuss"):
        try:
            BACKENDS[name].check(cfg)
            return name
        except (NotImplementedError, ValueError):
            pass
    return "ntt"


@dataclasses.dataclass(eq=False)
class EvaluationKey:
    """A key's evaluation side (the module docstring), made from its
    configuration, its standard BSK, its device and its backend choice
    ("mxu", "nuss", "ntt" or "auto"). `forms` maps a backend to its form,
    `graphs` a slot to its GraphedCall."""

    cfg: ServerConfig
    bsk_standard: np.ndarray = dataclasses.field(repr=False)
    device: torch.device
    choice: str = "auto"
    forms: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False)
    graphs: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)
    pool: GraphPool = dataclasses.field(default_factory=GraphPool,
                                        init=False, repr=False)

    @functools.cached_property
    def backend(self) -> str:
        """The backend that runs: resolve_backend(cfg, choice)."""
        return resolve_backend(self.cfg, self.choice)

    def form(self, backend: str | None = None) -> torch.Tensor:
        """The BSK in `backend`'s evaluation form (the running backend's
        by default), built on the device at first use."""
        backend = backend or self.backend
        if backend not in self.forms:
            self.forms[backend] = BACKENDS[backend].prepare(
                self.bsk_standard, self.cfg, self.device)
        return self.forms[backend]

    def graphed(self, slot, make, n_static: int, name: str) -> GraphedCall:
        """The GraphedCall of `slot`, made at its first use from `make()`
        (a function whose first `n_static` arguments are static), named
        "<name> (<backend>)" and capturing into the key's pool."""
        call = self.graphs.get(slot)
        if call is None:
            call = self.graphs[slot] = GraphedCall(
                make(), n_static, name=f"{name} ({self.backend})",
                pool=self.pool)
        return call

    def to(self, device) -> "EvaluationKey":
        """The same key on `device`: its forms moved, not rebuilt, and no
        graph (graphs are per device)."""
        moved = EvaluationKey(self.cfg, self.bsk_standard,
                              torch.device(device), self.choice)
        moved.forms.update({b: t.to(device) for b, t in self.forms.items()})
        return moved


class EvaluationForms:
    """The public names of a key that holds an `evaluation` (ServerKey,
    LWEBSK); each form is built on the key's device at first use."""

    def resolved_backend(self) -> str:
        """The backend the key runs: `backend` when it is "mxu", "nuss" or
        "ntt" (checked against the configuration), else the one
        resolve_backend picks for "auto"."""
        return self.evaluation.backend

    @property
    def bsk_mxu(self) -> torch.Tensor:
        """Toeplitz rotation rings [n, R, (k+1)*n_words, 2N] int32."""
        return self.evaluation.form("mxu")

    @property
    def bsk_nuss(self) -> torch.Tensor:
        """Nussbaumer-domain rings [n, 2L*R', (k+1)*n_words, 2M] int32."""
        return self.evaluation.form("nuss")

    @property
    def bsk_ntt(self) -> torch.Tensor:
        """NTT spectra [n, P, l, k+1, k+1, N] int32."""
        return self.evaluation.form("ntt")
