"""GGSW encryption and the bootstrap key (crypto/secret/glwe.rs,
crypto/bootstrap/standard/mod.rs), client side.

A GGSW ciphertext is [l, k+1, k+1, N]: `level` matrices of k+1 GLWE rows. A
bootstrap key is one GGSW per LWE key bit, [n, l, k+1, k+1, N] np.uint32
or np.uint64 (the GLWE key's torus). Randomness is drawn from forked
children of the AES-CTR streams in the reference's order, as concrete_tpu
draws it, so equal seeds give the same bytes; the rows are assembled with
one batched multisum, on a device of the caller's choice. bsk_to_ntt
converts a key to the ntt backend's spectra.

Example:
    >>> from concrete_tpu_torch.core.glwe import GlweSecretKey
    >>> from concrete_tpu_torch.core.lwe import LweSecretKey
    >>> from concrete_tpu_torch.csprng import EncryptionRandomGenerator, SecretRandomGenerator
    >>> sgen = SecretRandomGenerator(1)
    >>> lsk = LweSecretKey.generate_binary(3, sgen)
    >>> gsk = GlweSecretKey.generate_binary(1, 16, sgen)
    >>> bsk = StandardBootstrapKey.generate(lsk, gsk, 4, 2, 0.0,
    ...                                     EncryptionRandomGenerator(2, 3))
    >>> bsk.data.shape, int(bsk.data[0, 0, 0, 0, 0])   # [n, levels, k+1, k+1, N]
    ((3, 2, 2, 2, 16), 600971201)
    >>> g = encrypt_constant_ggsw(gsk, 1, 4, 2, 0.0, EncryptionRandomGenerator(1, 2))
    >>> g.shape                                         # [levels, k+1, k+1, N]
    (2, 2, 2, 16)
    >>> gsk64 = GlweSecretKey.generate_binary(1, 16, sgen, bits=64)
    >>> StandardBootstrapKey.generate(lsk, gsk64, 4, 2, 0.0,
    ...     EncryptionRandomGenerator(2, 3)).data.dtype
    dtype('uint64')
    >>> spectra = bsk_to_ntt(bsk.data, (2013265921, 1811939329), 32)
    >>> spectra.shape, spectra.dtype          # [n, P, levels, k+1, k+1, N]
    (torch.Size([3, 2, 2, 2, 2, 16]), torch.int32)
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..csprng import EncryptionRandomGenerator
from ..csprng.generator import AesCtrGenerator, State
from ..csprng.random import RandomGenerator, batch_fill_gaussian_torus
from ..torus import UNSIGNED, as_torus, to_numpy
from .glwe import GlweSecretKey, glwe_to_ntt


def _draw_ggsw_randomness(glwe_key: GlweSecretKey, level_count: int,
                          std: float, gen: EncryptionRandomGenerator):
    """Mask and noise of one GGSW in the reference's fork order
    (secret/glwe.rs:775-820): a fork per level, then per row; each row draws
    noise [N], then masks [k, N] from its own child."""
    bits = glwe_key.bits
    k, n = glwe_key.dimension, glwe_key.polynomial_size
    masks = np.zeros((level_count, k + 1, k, n), dtype=UNSIGNED[bits])
    noises = np.zeros((level_count, k + 1, n), dtype=UNSIGNED[bits])
    for lev_idx, lev_gen in enumerate(
            gen.fork_ggsw_to_ggsw_levels(bits, level_count, k + 1, n)):
        for row_idx, row_gen in enumerate(
                lev_gen.fork_ggsw_level_to_glwe(bits, k + 1, n)):
            m, nz = glwe_key.draw_randomness(1, std, row_gen)
            masks[lev_idx, row_idx] = m[0]
            noises[lev_idx, row_idx] = nz[0]
    return masks, noises


def encrypt_constant_ggsw(glwe_key: GlweSecretKey, value: int, base_log: int,
                          level_count: int, std: float,
                          gen: EncryptionRandomGenerator,
                          device=None) -> np.ndarray:
    """GGSW encryption of a constant -> [l, k+1, k+1, N]
    (secret/glwe.rs:775-860): each row a fresh encryption of zero from its
    forked child, plus value * q/B^level at coefficient 0 of the row's
    diagonal polynomial."""
    masks, noises = _draw_ggsw_randomness(glwe_key, level_count, std, gen)
    return assemble_ggsw(glwe_key, int(value), base_log, level_count, masks,
                         noises, device=device)[0]


def assemble_ggsw(glwe_key: GlweSecretKey, value: int, base_log: int,
                  level_count: int, masks: np.ndarray, noises: np.ndarray,
                  values: np.ndarray | None = None,
                  device=None) -> np.ndarray:
    """GGSW rows from randomness: masks [l, k+1, k, N] or [n, l, k+1, k, N],
    noises [l, k+1, N] or [n, l, k+1, N] -> [n, l, k+1, k+1, N]
    (n = 1 without `values`), encryptions of zero plus the gadget constants
    of `value` (or of each of `values` [n]) on the diagonals; the products
    run on `device`."""
    rows = glwe_key.encrypt_from_randomness(
        masks, noises, np.zeros(noises.shape, dtype=noises.dtype), device)
    if values is None:
        values = np.array([value], dtype=np.int64)
        rows = rows[None]
    _add_gadget_diagonals(rows, values, base_log, level_count, glwe_key.bits)
    return rows


def _add_gadget_diagonals(rows: np.ndarray, values: np.ndarray,
                          base_log: int, level_count: int, bits: int):
    """Add value_b * q/B^level to coefficient 0 of each level matrix's
    diagonal polynomials, in place (secret/glwe.rs:831-856)."""
    shifts = np.array([bits - base_log * (lev + 1)
                       for lev in range(level_count)], dtype=np.uint64)
    summands = (np.asarray(values).astype(np.uint64)[:, None]
                << shifts[None, :]).astype(UNSIGNED[bits])     # [n, l]
    for row_idx in range(rows.shape[2]):
        rows[:, :, row_idx, row_idx, 0:1] += summands[:, :, None]


@dataclasses.dataclass
class StandardBootstrapKey:
    """Coefficient-domain bootstrap key, data [n, l, k+1, k+1, N] np.uint32
    or np.uint64 (bootstrap/standard/mod.rs:57-210)."""

    data: np.ndarray
    base_log: int
    level_count: int
    bits: int = 32

    @classmethod
    def generate(cls, lwe_key, glwe_key: GlweSecretKey, base_log: int,
                 level_count: int, std: float, gen: EncryptionRandomGenerator,
                 *, batched: bool = True, device=None,
                 timings: dict | None = None) -> "StandardBootstrapKey":
        """fill_with_new_key (standard/mod.rs:172-209): one GGSW encryption of
        each LWE key bit under the GLWE key, the generator forked per key
        bit, with the same bytes as concrete_tpu and as the reference's
        rayon par_fill; the mask-times-key products run on `device` (the CPU
        by default).

        ``batched=False`` draws the randomness bit after bit. The default
        reads it in bulk: the nested fork budgets (key bit -> level -> row)
        are consumed exactly by the mask draws, so the whole mask tensor is
        one contiguous range of the parent's mask stream from its state
        before the fork, read in one sweep; every row's noise child is
        drawn by one batch_fill_gaussian_torus. The multisum is dispatched
        on the device before the host draws the noise, and its result
        copied into pinned memory without blocking, so that on a GPU the
        products and the copy run under the noise draw; the host waits on
        the copy's event before it reads the result. `timings`, when given,
        receives the batched form's host seconds by part (fork tree, mask
        read, multisum dispatch, noise draw, wait for the products,
        assembly) and, on a GPU, the products' device ms between two CUDA
        events."""
        bits = glwe_key.bits
        k, n = glwe_key.dimension, glwe_key.polynomial_size
        n_lwe = lwe_key.dimension
        values = lwe_key.key.astype(np.int64)
        if not batched:
            dt = UNSIGNED[bits]
            masks = np.zeros((n_lwe, level_count, k + 1, k, n), dtype=dt)
            noises = np.zeros((n_lwe, level_count, k + 1, n), dtype=dt)
            for i, g in enumerate(gen.fork_bsk_to_ggsw(bits, n_lwe, level_count,
                                                       k + 1, n)):
                masks[i], noises[i] = _draw_ggsw_randomness(
                    glwe_key, level_count, std, g)
            data = assemble_ggsw(glwe_key, 0, base_log, level_count, masks,
                                 noises, values=values, device=device)
            return cls(data, base_log, level_count, bits)

        clock = [time.perf_counter()]
        marks = {}

        def mark(name):
            clock.append(time.perf_counter())
            marks[name] = clock[-1] - clock[-2]

        mask_start = gen.mask.inner.state.gpos
        noise_gens = []
        for g in gen.fork_bsk_to_ggsw(bits, n_lwe, level_count, k + 1, n):
            for lev_gen in g.fork_ggsw_to_ggsw_levels(bits, level_count,
                                                      k + 1, n):
                noise_gens.extend(
                    rg.noise for rg in lev_gen.fork_ggsw_level_to_glwe(
                        bits, k + 1, n))
        mark("fork_s")
        reader = RandomGenerator(_inner=AesCtrGenerator(
            state=State(gpos=mask_start),
            _round_keys=gen.mask.inner.round_keys))
        rows = n_lwe * level_count * (k + 1)
        masks = reader.random_uniform_array(rows * k * n, bits).reshape(
            n_lwe, level_count, k + 1, k, n)
        mark("mask_read_s")
        on_gpu = torch.device(device or "cpu").type == "cuda"
        if on_gpu:
            start, ready = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            start.record()
        products = glwe_key.multisum(masks, device)
        if on_gpu:
            host = torch.empty(products.shape, dtype=products.dtype,
                               pin_memory=True)
            host.copy_(products, non_blocking=True)
            ready.record()
            products = host
        mark("multisum_dispatch_s")
        noises = batch_fill_gaussian_torus(noise_gens, n, std, bits).reshape(
            n_lwe, level_count, k + 1, n)
        mark("noise_draw_s")
        if on_gpu:
            ready.synchronize()
            marks["multisum_device_ms"] = start.elapsed_time(ready)
        mark("multisum_wait_s")
        bodies = noises + to_numpy(products)
        data = np.concatenate([masks, bodies[..., None, :]], axis=-2)
        _add_gadget_diagonals(data, values, base_log, level_count, bits)
        mark("assemble_s")
        if timings is not None:
            timings.update(marks)
        return cls(data, base_log, level_count, bits)


def ggsw_to_ntt(ggsw, primes: tuple[int, ...], bits: int, *,
                device=None) -> torch.Tensor:
    """Forward-NTT every polynomial of a GGSW tensor [..., N] (u32 / u64
    torus) -> [P, ..., N] Montgomery spectra in bit-reversed order, u32
    words as int32 (values below 2^31). Coefficients are centered (signed)
    before the residue reduction, which halves the CRT bound
    (bootstrap/fourier/mod.rs:186 fill_with_forward_fourier). Runs on
    `device`, else the tensor's own, else the CPU for numpy input."""
    return glwe_to_ntt(ggsw, primes, bits, device=device)


def bsk_to_ntt(bsk_data, primes: tuple[int, ...], bits: int, *,
               device=None) -> torch.Tensor:
    """[n, l, k+1, k+1, N] bootstrap key -> [n, P, l, k+1, k+1, N] int32
    spectra (concrete_tpu's bsk_to_ntt, byte for byte), the CMux-chain axis
    leading so each step reads one contiguous slice. Converted on the key's
    device (see ggsw_to_ntt) in slices of the n axis, so the int64
    temporaries stay near a few hundred MB."""
    bsk = as_torus(bsk_data, device, bits)
    n_lwe, per_row = bsk.shape[0], bsk[0].numel()
    out = torch.empty((n_lwe, len(primes)) + tuple(bsk.shape[1:]),
                      dtype=torch.int32, device=bsk.device)
    step = max(1, (1 << 22) // (len(primes) * per_row))
    for i0 in range(0, n_lwe, step):
        out[i0:i0 + step] = ggsw_to_ntt(bsk[i0:i0 + step], primes,
                                        bits).movedim(0, 1)
    return out
