"""Server key and homomorphic boolean gates (concrete-boolean/src/server_key).

Every bootstrapped gate is a linear combination, a PBS with the constant
+1/8 test polynomial, then a keyswitch back to the small key:
  AND:  l + r - 1/8        NAND: -l - r + 1/8
  OR:   l + r + 1/8        NOR:  -l - r - 1/8
  XOR:  2(l + r) + 1/4     XNOR: 2(-l - r) - 1/4
  NOT:  -l (no bootstrap)  MUX:  pbs(c+t-1/8) + pbs(-c+e-1/8) + 1/8, keyswitch
With `backend="auto"` the PBS runs through the exact-NTT ("ntt") backend
wherever its CRT primes take the configuration, else the toeplitz ("mxu")
backend for N <= 4096 and the Nussbaumer ("nuss") backend above
(core/backends.resolve_backend); or through the one named by `backend`.
The three are bit-identical. Gates take np.uint32 arrays or int32
tensors [..., n+1] and return int32 tensors on the key's device. On the
card each gate call replays one captured CUDA graph per (gate, padded
tier) holding the whole gate (_gate_pipeline, _mux_pipeline: concrete_tpu's
jitted pipelines), made at warmup or at the tier's first call
(ops/graphs.py); on the CPU the pipelines run as they are. Under a
torch.profiler session each gate call is a span `gate.<gate>` holding
`gate.pad` (the inputs onto the device, broadcast, flattened and padded)
and `gate.cut`; `GATE_ROWS` counts every call's request rows and padding
rows.

Example (AND and XOR on tiny insecure parameters, on the CPU):
    >>> from concrete_tpu_torch import boolean
    >>> from concrete_tpu_torch.params import BooleanParameters
    >>> from concrete_tpu_torch.dispersion import StandardDev
    >>> tiny = BooleanParameters(4, 1, 64, StandardDev(2.0 ** -20),
    ...     StandardDev(2.0 ** -25), 7, 3, 2, 5)
    >>> cks, sks = boolean.gen_keys(tiny, secret_seed=1, mask_seed=2,
    ...                             noise_seed=3, device="cpu")
    >>> a = cks.encrypt([True, True, False, False], mask_seed=4, noise_seed=5)
    >>> b = cks.encrypt([True, False, True, False], mask_seed=6, noise_seed=7)
    >>> cks.decrypt(sks.and_(a, b)).tolist(), cks.decrypt(sks.xor(a, b)).tolist()
    ([True, False, False, False], [False, True, True, False])
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from ..core import bootstrap as bs
from ..core import lwe as lwe_ops
from ..core.backends import BACKENDS, EvaluationForms, EvaluationKey
from ..core.ggsw import StandardBootstrapKey
from ..csprng import EncryptionRandomGenerator
from ..ops import _cuda, graphs
from ..params import BooleanParameters
from ..torus import as_torus, i32
from .client_key import ClientKey, PLAINTEXT_LOG_SCALING_FACTOR, PLAINTEXT_TRUE

# gate offsets as int32 bit patterns (the negative ones are u32 > 2^31)
_EIGHTH = i32(1 << (32 - PLAINTEXT_LOG_SCALING_FACTOR))
_QUARTER = i32(1 << (32 - PLAINTEXT_LOG_SCALING_FACTOR + 1))
_NEG_EIGHTH = i32(-(1 << (32 - PLAINTEXT_LOG_SCALING_FACTOR)))
_NEG_QUARTER = i32(-(1 << (32 - PLAINTEXT_LOG_SCALING_FACTOR + 1)))

# linear combination per gate (server_key/mod.rs:133-614): lin(a, b), offset
_GATE_LIN = {
    "and": (lambda a, b: a + b, _NEG_EIGHTH),
    "nand": (lambda a, b: -a - b, _EIGHTH),
    "or": (lambda a, b: a + b, _EIGHTH),
    "nor": (lambda a, b: -a - b, _NEG_EIGHTH),
    "xor": (lambda a, b: (a + b) * 2, _QUARTER),
    "xnor": (lambda a, b: (-a - b) * 2, _NEG_QUARTER),
}


def gate_linear(gate: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The ciphertexts a two-input gate bootstraps: its linear combination
    of `a` and `b` plus its offset (_GATE_LIN), int32 bit patterns."""
    lin_fn, offset = _GATE_LIN[gate]
    lin = lin_fn(a, b)
    lin[..., -1] += offset
    return lin


def pad_size(tiers, b: int) -> int:
    """Padded batch for a `b`-row call: the smallest of `tiers` that fits,
    else the next power of two (a tier of its own).

    >>> pad_size({64, 2048}, 100), pad_size({64}, 100), pad_size((), 1)
    (2048, 128, 1)
    """
    fitting = [t for t in tiers if t >= b]
    if fitting:
        return min(fitting)
    return 1 << (b - 1).bit_length() if b > 1 else 1


def flat_inputs(cts, device) -> tuple[list, torch.Size]:
    """Ciphertext batches onto `device`, broadcast together and flattened to
    [rows, n+1]; returns them and the broadcast leading shape."""
    cts = torch.broadcast_tensors(*[as_torus(c, device) for c in cts])
    return [c.reshape(-1, c.shape[-1]) for c in cts], cts[0].shape[:-1]


def pad_rows(flats: list, padded: int) -> list:
    """Each [rows, n+1] batch zero-padded to `padded` rows; the padding rows
    bootstrap harmlessly and are cut off after the call."""
    b = flats[0].shape[0]
    if padded == b:
        return flats
    return [torch.cat([f, f.new_zeros((padded - b, f.shape[1]))])
            for f in flats]


_GATE_SPANS = {gate: f"gate.{gate}" for gate in _GATE_LIN}
# rows of every gate call: "request" (asked for) and "padding" (added)
GATE_ROWS = graphs.Counter("gate_rows")


# the ServerConfig fields of the npz key format (u32 torus, exact)
_SAVED_CONFIG = ("lwe_dimension", "glwe_dimension", "polynomial_size",
                 "pbs_base_log", "pbs_level", "ks_base_log", "ks_level")


@dataclasses.dataclass
class ServerKey(EvaluationForms):
    """Coefficient-domain bootstrap key + keyswitch key + configuration.

    The evaluation forms (toeplitz or Nussbaumer rings or NTT spectra of the
    BSK, int8 limb planes of the KSK) are derived from the stored arrays at
    first use, on `device`. `backend` is "mxu", "nuss", "ntt" or "auto"
    (resolved_backend). `evaluation` (core/backends.py) holds the BSK's
    forms and the gate pipelines' graphs, one graph per tier each."""

    ksk: np.ndarray               # [k*N, l_ks, n+1] np.uint32
    cfg: bs.ServerConfig
    bsk_standard: np.ndarray      # [n, l, k+1, k+1, N] np.uint32
    device: torch.device | str | None = None   # None: the GPU (required)
    backend: str = "auto"
    _ksk8: torch.Tensor | None = dataclasses.field(default=None, repr=False)
    _lut_t: torch.Tensor | None = dataclasses.field(
        default=None, repr=False, compare=False)
    # batch tiers run by warmup(); _pad_size pads smaller requests up to them
    _warmed_tiers: set = dataclasses.field(
        default_factory=set, repr=False, compare=False)
    evaluation: EvaluationKey = dataclasses.field(
        init=False, repr=False, compare=False)

    def __post_init__(self):
        c = self.cfg
        self.device = _cuda.resolve_device(self.device)
        self._warmed_tiers = set(self._warmed_tiers)
        bsk_shape = (c.lwe_dimension, c.pbs_level, c.glwe_size, c.glwe_size,
                     c.polynomial_size)
        ksk_shape = (c.big_lwe_dimension, c.ks_level, c.lwe_dimension + 1)
        if self.bsk_standard.shape != bsk_shape or self.ksk.shape != ksk_shape:
            raise ValueError(
                f"key shapes {self.bsk_standard.shape} / {self.ksk.shape} do "
                f"not match the configuration ({bsk_shape} / {ksk_shape})")
        self.evaluation = EvaluationKey(self.cfg, self.bsk_standard,
                                        self.device, self.backend)

    @property
    def ksk8(self) -> torch.Tensor:
        """The keyswitch key's int8 limb planes [k*N*l_ks, 4*(n+1)]
        (lwe.ksk_to_limbs) on the device, which every gate switches with
        (lwe.keyswitch_prepared: the int8-digit product where it takes the
        key, the general keyswitch's elsewhere; on every backend the bits
        of concrete_tpu's u32 keyswitch)."""
        if self._ksk8 is None:
            self._ksk8 = torch.from_numpy(
                lwe_ops.ksk_to_limbs(self.ksk)).to(self.device)
        return self._ksk8

    # -- construction and storage -------------------------------------------

    @classmethod
    def new(cls, cks: ClientKey, *, mask_seed: int | None = None,
            noise_seed: int | None = None, device=None) -> "ServerKey":
        """ServerKey::new (server_key/mod.rs:55-111): the BSK under the GLWE
        key and the keyswitch key from the big LWE key back to the small one.
        Masks and noise come from the AES-CTR streams seeded with
        `mask_seed` and `noise_seed`: concrete_tpu's bytes. The BSK's
        mask-times-key products run on `device`."""
        p = cks.parameters
        device = _cuda.resolve_device(device)
        gen = EncryptionRandomGenerator(mask_seed, noise_seed)
        bsk = StandardBootstrapKey.generate(
            cks.lwe_secret_key, cks.glwe_secret_key, p.pbs_base_log,
            p.pbs_level, p.glwe_modular_std_dev.std_dev, gen, device=device)
        ksk = lwe_ops.LweKeyswitchKey.generate(
            cks.glwe_secret_key.into_lwe_key(), cks.lwe_secret_key,
            p.ks_base_log, p.ks_level, p.lwe_modular_std_dev.std_dev, gen)
        return cls.from_arrays(bsk.data, ksk.data, p, device=device)

    @classmethod
    def from_arrays(cls, bsk_standard, ksk, params: BooleanParameters, *,
                    device=None) -> "ServerKey":
        """From a [n, l, k+1, k+1, N] BSK and a [k*N, l_ks, n+1] KSK, u32."""
        return cls(ksk=np.asarray(ksk, dtype=np.uint32),
                   cfg=bs.ServerConfig.from_boolean_parameters(params),
                   bsk_standard=np.asarray(bsk_standard, dtype=np.uint32),
                   device=device)

    def save(self, path: str):
        """Serialize in the npz format of concrete_tpu's ServerKey.save,
        plus the backend choice (an entry concrete_tpu's load ignores)."""
        np.savez_compressed(
            path, bsk=self.bsk_standard, ksk=self.ksk, backend=self.backend,
            **{name: getattr(self.cfg, name) for name in _SAVED_CONFIG})

    @classmethod
    def load(cls, path: str, *, device=None) -> "ServerKey":
        """Read a key written by `save` or by concrete_tpu's ServerKey.save
        (which stores no backend: "auto")."""
        with np.load(path, allow_pickle=False) as d:
            cfg = bs.ServerConfig(**{name: int(d[name])
                                     for name in _SAVED_CONFIG})
            backend = str(d["backend"]) if "backend" in d.files else "auto"
            return cls(ksk=d["ksk"].astype(np.uint32), cfg=cfg,
                       bsk_standard=d["bsk"].astype(np.uint32), device=device,
                       backend=backend)

    def to(self, device) -> "ServerKey":
        """The same key on another device (evaluation forms moved, not
        rebuilt; warmed tiers and graphs are per device and start empty)."""
        move = (lambda t: None if t is None else t.to(device))
        key = dataclasses.replace(
            self, device=torch.device(device), _ksk8=move(self._ksk8),
            _lut_t=move(self._lut_t), _warmed_tiers=set())
        key.evaluation = self.evaluation.to(key.device)
        return key

    def with_fast_mode(self, *, limb_drop: int = 0,
                       levels: int | None = 2) -> "ServerKey":
        """A reduced-precision twin over the same key material, as
        concrete_tpu's ServerKey.with_fast_mode: ``levels`` keeps only the
        most significant PBS decomposition levels (the bootstrap key is
        sliced), ``limb_drop`` rounds the bootstrap-key operand of the
        toeplitz product (which the JAX package advises against on the u32
        torus; the nuss and ntt backends ignore it). The keyswitch key,
        client keys and ciphertexts are unchanged."""
        cfg = self.cfg.with_fast_mode(limb_drop=limb_drop, levels=levels)
        return dataclasses.replace(
            self, cfg=cfg, bsk_standard=self.bsk_standard[:, :cfg.pbs_level],
            _warmed_tiers=set())

    # -- batching ------------------------------------------------------------

    def _pad_size(self, b: int) -> int:
        """Padded batch for a `b`-row gate call: the smallest warmed tier that
        fits, else the next power of two (pad_size)."""
        return pad_size(self._warmed_tiers, b)

    def _padded_call(self, fn, *cts):
        """Call `fn` on the ciphertext batches broadcast together, flattened
        and zero-padded to `_pad_size` rows (flat_inputs, pad_rows); the
        padding rows bootstrap harmlessly and are cut off."""
        with graphs.span("gate.pad"):
            flats, lead = flat_inputs(cts, self.device)
            b = flats[0].shape[0]
            if b == 0:
                return torch.zeros(lead + flats[0].shape[-1:],
                                   dtype=torch.int32, device=self.device)
            padded = self._pad_size(b)
            flats = pad_rows(flats, padded)
        GATE_ROWS.add(b, "request")
        GATE_ROWS.add(padded - b, "padding")
        out = fn(*flats)
        with graphs.span("gate.cut"):
            return out[:b].reshape(lead + out.shape[-1:])

    def warmup(self, batch_sizes=(2048,), gates=("and",), mux=False):
        """Build the CUDA kernels (on a CUDA key) and make each (gate, batch
        tier)'s graph, plus MUX's when `mux` is set, as concrete_tpu's
        ServerKey.warmup compiles one program each; the first call also
        moves the evaluation keys onto the device. A graph is one run of the
        gate on a side stream, its capture and one replay (on a CPU key, one
        call). Gates are named as there ("and", "xor", ... the keys of
        _GATE_LIN). Each size is rounded up to a power-of-two tier; later
        gate calls pad every request up to the smallest warmed tier that
        fits. Returns {(gate, tier): seconds}."""
        unknown = [g for g in gates if g not in _GATE_LIN]
        if unknown:
            raise ValueError(f"gates {unknown}: expected names among "
                             f"{sorted(_GATE_LIN)}")
        if self.device.type == "cuda":
            _cuda.load_all()

        def timed(fn):
            t0 = time.perf_counter()
            fn()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return time.perf_counter() - t0

        timings = {}
        for bsz in batch_sizes:
            tier = pad_size((), int(bsz))
            self._warmed_tiers.add(tier)
            z = torch.zeros((tier, self.cfg.lwe_dimension + 1),
                            dtype=torch.int32, device=self.device)
            for gate in gates:
                timings[(gate, tier)] = timed(
                    lambda gate=gate: self._run_gate(gate, z, z))
            if mux:
                timings[("mux", tier)] = timed(lambda: self.mux(z, z, z))
        return timings

    # -- gates ---------------------------------------------------------------

    def _lut(self) -> torch.Tensor:
        """The gates' test polynomial (constant body 1/8), made once per key
        on its device: a copy from the host, which no graph capture holds."""
        if self._lut_t is None:
            self._lut_t = bs.trivial_lut_constant(self.cfg, PLAINTEXT_TRUE,
                                                  self.device)
        return self._lut_t

    def gate_keys(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """What every gate pipeline takes before its ciphertexts, on the
        device: the BSK in the running backend's form, the keyswitch key's
        limb planes (ksk8) and the test polynomial."""
        return self.evaluation.form(), self.ksk8, self._lut()

    def _run_gate(self, gate: str, ct_left, ct_right) -> torch.Tensor:
        with graphs.span(_GATE_SPANS[gate]):
            ev = self.evaluation
            call = ev.graphed(gate, lambda: _gate_pipeline(
                self.cfg, ev.backend, gate), 3, gate)
            keys = self.gate_keys()
            return self._padded_call(lambda a, b: call(*keys, a, b),
                                     ct_left, ct_right)

    def and_(self, ct_left, ct_right):
        return self._run_gate("and", ct_left, ct_right)

    def nand(self, ct_left, ct_right):
        return self._run_gate("nand", ct_left, ct_right)

    def or_(self, ct_left, ct_right):
        return self._run_gate("or", ct_left, ct_right)

    def nor(self, ct_left, ct_right):
        return self._run_gate("nor", ct_left, ct_right)

    def xor(self, ct_left, ct_right):
        return self._run_gate("xor", ct_left, ct_right)

    def xnor(self, ct_left, ct_right):
        return self._run_gate("xnor", ct_left, ct_right)

    def not_(self, ct):
        """Free negation, no bootstrap (server_key/mod.rs:422-429)."""
        return -as_torus(ct, self.device)

    def mux(self, ct_condition, ct_then, ct_else):
        """(c ? t : e) via two PBS sharing one blind rotation batch, then one
        keyswitch (server_key/mod.rs:197-279)."""
        with graphs.span("gate.mux"):
            ev = self.evaluation
            call = ev.graphed("mux", lambda: _mux_pipeline(
                self.cfg, ev.backend), 3, "mux")
            keys = self.gate_keys()
            return self._padded_call(lambda c, t, e: call(*keys, c, t, e),
                                     ct_condition, ct_then, ct_else)


@functools.lru_cache(maxsize=None)
def _gate_pipeline(cfg: bs.ServerConfig, backend: str, gate: str):
    """The full gate, concrete_tpu's jitted pipeline of the same name:
    fn(bsk, ksk8, lut, a, b) -> the linear combination and offset, the PBS
    with the constant 1/8 test polynomial on `backend`, the keyswitch.
    ServerKey captures it as one CUDA graph per (gate, padded tier). The
    LUT is an argument, made once per key (ServerKey.gate_keys): concrete_tpu
    builds it inside the jitted program, where here it would be a copy from
    the host inside the capture."""
    bks = BACKENDS[backend].bootstrap_keyswitch

    def run(bsk, ksk8, lut, a, b):
        return bks(cfg, bsk, ksk8, lut, gate_linear(gate, a, b))

    return run


@functools.lru_cache(maxsize=None)
def _mux_pipeline(cfg: bs.ServerConfig, backend: str):
    """MUX in one pipeline, concrete_tpu's of the same name: fn(bsk, ksk8,
    lut, c, t, e) -> both linear combinations, the two PBS stacked on one
    batch axis (one blind rotation), their sum plus 1/8, the keyswitch."""
    pbs_fn = BACKENDS[backend].bootstrap

    def run(bsk, ksk8, lut, c, t, e):
        lin1 = c + t
        lin1[..., -1] += _NEG_EIGHTH
        lin2 = e - c
        lin2[..., -1] += _NEG_EIGHTH
        pbs = pbs_fn(cfg, bsk, lut, torch.stack([lin1, lin2]))
        summed = pbs[0] + pbs[1]
        summed[..., -1] += _EIGHTH
        return lwe_ops.keyswitch_prepared(
            ksk8, summed, base_log=cfg.ks_base_log, level_count=cfg.ks_level)

    return run
