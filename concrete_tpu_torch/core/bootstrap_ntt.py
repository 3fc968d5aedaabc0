"""The exact-NTT ("ntt") backend of the bootstrap (the ntt parts of
concrete_tpu/core/bootstrap.py, with K9 of concrete_tpu/ops/pallas_cmux.py).

The external product is computed modulo the CRT primes of the configuration
(``ServerConfig.primes``): the gadget digits are transformed with an exact
negacyclic NTT per prime (math/ntt.py), multiplied pointwise with the
bootstrap key's spectra (core/ggsw.bsk_to_ntt), transformed back and
recombined by Garner's algorithm (math/crt.py) into the torus. Every step is
exact, so the result is the toeplitz and Nussbaumer backends' bits.

On the u32 torus with two primes, the JAX kernel's own precondition, which
the three boolean presets meet, each CMux step of the blind rotation is one
CUDA kernel on the card (K9, `ntt_cmux`, csrc/ntt_kernels.cu): the rotation,
the signed gadget digits, per prime the forward NTT of every digit
polynomial, the pointwise MAC against the GGSW spectra, the inverse NTT, the
two-prime Garner recombination and the accumulate. It has two paths, chosen
by shape (`path`): at N in WARP_N (the presets' 256, 512, 1024) a warp holds
each polynomial's transform in its registers (`warp_geometry`); elsewhere
every transform runs in shared memory, several batch rows a block
(`block_geometry`). The launch counts' shape key ends in the path. Elsewhere
(the u64 torus has three or more primes) the step is the stacked torch
composition, `ntt_cmux_plain`, as the JAX package runs its XLA form there.
On CPU tensors `ntt_cmux` runs the plain version; `ntt_cmux.launches`
counts the kernel launches.

Example (one step on the CPU, where the plain version runs):
    >>> import torch
    >>> cfg = ServerConfig(lwe_dimension=4, glwe_dimension=1,
    ...     polynomial_size=64, pbs_base_log=6, pbs_level=2, ks_base_log=4,
    ...     ks_level=3)
    >>> kernel_applies(cfg), cols_per_block(cfg.glwe_size, 16384)
    (True, 1)
    >>> acc = torch.zeros((2, 3, 64), dtype=torch.int32)
    >>> ggsw = torch.zeros((2, 2, 2, 2, 64), dtype=torch.int32)
    >>> a_hat = torch.tensor([0, 5, 127], dtype=torch.int32)
    >>> ntt_cmux(cfg, acc, a_hat, ggsw).abs().max().item()
    0
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..math import crt, decomposition, ntt, polynomial
from ..ops import _cuda, graphs
from ..torus import carrier
from . import checks
from . import lwe as lwe_ops
from .bootstrap import (
    ServerConfig,
    rotation_start,
    sample_extract,
    sample_extract_nth,
)
from .bootstrap_mxu import _check, _on_cpu

# ---------------------------------------------------------------------------
# external product, CMux
# ---------------------------------------------------------------------------


def _external_product_stacked(cfg: ServerConfig, sp: ntt.StackedNttPlans,
                              ggsw_ntt: torch.Tensor, glwe_pbn: torch.Tensor,
                              level0: int = 0, reduce=None) -> torch.Tensor:
    """The external product with every CRT prime in one tensor.

    ggsw_ntt [P, l, k+1, k+1, N] Montgomery spectra (int32 or int64);
    glwe_pbn [k+1, B, N] in the torus carrier. Returns [k+1, B, N] in the
    carrier, exact (fourier/mod.rs:463-645).

    A tensor-parallel rank (parallel/mesh.py) passes the levels it holds,
    ggsw_ntt [P, l', ...] from decomposition level `level0` on, and
    `reduce`, which sums the partial MAC [P, k+1, B, N] over the ranks mod
    each prime before the inverse transform."""
    digits = decomposition.decompose_rounded(glwe_pbn, cfg.pbs_base_log,
                                             cfg.pbs_level)
    levels = ggsw_ntt.shape[1]
    digits = digits.movedim(-1, 0)[level0:level0 + levels]
    digits = digits.to(torch.int64)[None]                  # [1, l', k+1, B, N]
    p_bc = sp._bc(sp.p, digits)                            # [P, 1, 1, 1, 1]
    dres = torch.where(digits < 0, digits + p_bc, digits)  # [P, l', k+1, B, N]
    dspec = ntt.forward_stacked(sp, dres)
    g_all = ggsw_ntt.to(torch.int64)
    acc = None
    for lev in range(levels):
        for i in range(cfg.glwe_size):
            d = dspec[:, lev, i]                         # [P, B, N]
            g = g_all[:, lev, i]                         # [P, k+1, N]
            prod = sp.mont_mul(d[:, None], g[:, :, None, :])  # [P, k+1, B, N]
            acc = prod if acc is None else sp.add(acc, prod)
    if reduce is not None:
        acc = reduce(acc)
    residues = ntt.inverse_stacked(sp, acc)
    return cfg.crt_context.combine_to_torus(list(residues))


def _stacked_plans(cfg: ServerConfig) -> ntt.StackedNttPlans:
    return ntt.make_stacked_plans(cfg.polynomial_size, cfg.primes)


def external_product(cfg: ServerConfig, ggsw_ntt: torch.Tensor,
                     glwe: torch.Tensor) -> torch.Tensor:
    """<decomp(glwe), GGSW>: glwe [..., k+1, N] in the torus carrier,
    ggsw_ntt [P, l, k+1, k+1, N] (one GGSW of bsk_to_ntt)."""
    lead = glwe.shape[:-2]
    ks1, n = glwe.shape[-2:]
    pbn = glwe.reshape(-1, ks1, n).transpose(0, 1)      # [k+1, B, N]
    out = _external_product_stacked(cfg, _stacked_plans(cfg), ggsw_ntt, pbn)
    return out.transpose(0, 1).reshape(lead + (ks1, n))


def cmux(cfg: ServerConfig, ggsw_ntt: torch.Tensor, ct0: torch.Tensor,
         ct1: torch.Tensor) -> torch.Tensor:
    """ct0 + extprod(ggsw, ct1 - ct0): ct0 (bit 0) or ct1 (bit 1)
    (fourier/mod.rs:648-664)."""
    return ct0 + external_product(cfg, ggsw_ntt, ct1 - ct0)


# ---------------------------------------------------------------------------
# K9: one CMux step of the blind rotation
# ---------------------------------------------------------------------------

# shared memory one block may take on Hopper (227 KB, the hopper-kernels
# guide), in 32-bit words
_SMEM_WORDS = 232448 // 4
N_MAX = 16384
# the kernel's limits: output polynomials and batch rows one block takes
COLS_MAX, ROWS_MAX = 5, 4
# the warp path: the N at which one warp holds a polynomial's transform
# in its registers (N / 32 words a lane), and the threads a block may take
# (kWarpThreads in the kernel: a warp per polynomial and prime of one row)
WARP_N = (256, 512, 1024)
WARP_THREADS_MAX = 512
# shared memory the rows of one block may fill together when every digit
# polynomial fits, in words: 72 KB, which gives 2 rows at TPU128 and 1 at
# DEFAULT and TFHE_LIB, the fastest of 1-4 on the H100 (PERF.md, PR 5)
ROWS_SMEM_WORDS = 72 * 1024 // 4


def kernel_applies(cfg: ServerConfig) -> bool:
    """K9 takes the u32 torus with two CRT primes (pallas_cmux.py:130, 135)."""
    return cfg.bits == 32 and len(cfg.primes) == 2


def _padded(n: int) -> int:
    """Words of one polynomial in K9's shared memory: a pad word after
    every 8 keeps the radix passes' strided exchanges on distinct banks."""
    return n + n // 8


def cols_per_block(ks1: int, n: int) -> int:
    """Output polynomials one block accumulates: its shared memory holds
    two primes' spectra per column and at least one digit polynomial,
    (2*cols + 1) padded polynomials, and the kernel takes at most
    COLS_MAX. All k+1 fit up to N = 4096 when k+1 <= 5 (and at N = 8192
    for k = 1); beyond, the columns split over several blocks per row, each
    redoing the forward transforms of the digits."""
    return max(1, min(ks1, COLS_MAX, (_SMEM_WORDS // _padded(n) - 1) // 2))


def block_geometry(ks1: int, n: int, level: int,
                   batch: int) -> tuple[int, int, int]:
    """(cols, group, rows) of K9's blocks: `cols` output polynomials, the
    digit polynomials transformed `group` at a time (all 2*l*(k+1) of a row
    where they fit beside its column spectra, else as many as fit), and
    `rows` batch rows per block, as many as ROWS_SMEM_WORDS holds when
    every digit polynomial fits (at most ROWS_MAX and the batch), else 1.

    >>> [block_geometry(k1, n, l, 2048) for k1, n, l in
    ...  [(5, 256, 2), (3, 512, 2), (2, 1024, 3), (2, 8192, 3)]]
    [(5, 20, 2), (3, 12, 1), (2, 12, 1), (2, 2, 1)]
    """
    cols = cols_per_block(ks1, n)
    digits = 2 * level * ks1
    per_row = (2 * cols + digits) * _padded(n)
    if per_row > _SMEM_WORDS:
        return cols, _SMEM_WORDS // _padded(n) - 2 * cols, 1
    return cols, digits, max(1, min(ROWS_MAX, batch,
                                    ROWS_SMEM_WORDS // per_row))


def path(ks1: int, n: int) -> str:
    """K9's path for a shape: "warp" where a warp holds a polynomial's
    transform in its registers (N in WARP_N, and a warp per polynomial and
    prime of a row, 2*(k+1), within WARP_THREADS_MAX threads), else
    "block".

    >>> [path(ks1, n) for ks1, n in [(5, 256), (3, 512), (2, 1024),
    ...                              (2, 64), (2, 8192), (9, 512)]]
    ['warp', 'warp', 'warp', 'block', 'block', 'block']
    """
    return ("warp" if n in WARP_N and 64 * ks1 <= WARP_THREADS_MAX
            else "block")


def _warp_words(ks1: int, n: int, level: int, per_pass: int) -> int:
    """Shared-memory words of a block on the warp path, N + N/32 words a
    polynomial: the pass's spectra (per_pass primes, l*(k+1) each) and a
    scratch polynomial per prime and output polynomial, 2*(k+1); at N = 1024
    the scratch polynomials take the spectra's slots (with one prime a pass,
    the two primes' results lie past them).

    >>> [_warp_words(3, 512, 2, 2) // 528, _warp_words(2, 1024, 3, 2) // 1056]
    [18, 12]
    """
    if n == 1024:
        return (2 * level if per_pass == 2 else level + 2) * ks1 * (n + n // 32)
    return (per_pass * level + 2) * ks1 * (n + n // 32)


def warp_geometry(ks1: int, n: int, level: int) -> tuple[int]:
    """(per_pass,) of K9's warp path, one batch row a block: the primes
    whose spectra a pass holds, both where they fit beside the scratch
    polynomials in 227 KB, else one (two passes).

    >>> [warp_geometry(k1, n, l) for k1, n, l in
    ...  [(5, 256, 2), (3, 512, 2), (2, 1024, 3), (8, 1024, 4)]]
    [(2,), (2,), (2,), (1,)]
    """
    return (2 if _warp_words(ks1, n, level, 2) <= _SMEM_WORDS else 1),


def launch_geometry(ks1: int, n: int, level: int,
                    batch: int) -> tuple[str, tuple[int, ...]]:
    """(path, geometry) of K9's launch for a shape: warp_geometry on the
    warp path, block_geometry on the block path.

    >>> launch_geometry(3, 512, 2, 16), launch_geometry(2, 8192, 3, 16)
    (('warp', (2,)), ('block', (2, 2, 1)))
    """
    how = path(ks1, n)
    if how == "warp":
        return how, warp_geometry(ks1, n, level)
    return how, block_geometry(ks1, n, level, batch)


def ntt_cmux_plain(cfg: ServerConfig, acc: torch.Tensor, a_hat: torch.Tensor,
                   ggsw_i: torch.Tensor) -> torch.Tensor:
    """acc [k+1, B, N] (torus carrier) + the external product of ggsw_i
    [P, l, k+1, k+1, N] with X^a_hat * acc - acc, a_hat [B] int32 (read mod
    2N): rotate, difference, _external_product_stacked, add."""
    rot = polynomial.negacyclic_monomial_mul(acc, a_hat[None, :])
    return acc + _external_product_stacked(cfg, _stacked_plans(cfg), ggsw_i,
                                           rot - acc)


@functools.lru_cache(maxsize=None)
def _host_tables(n: int, primes: tuple) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's constants: tables [4, 2, N] u32 words as int32 (twist
    psi^i R^2; untwist psi^-i N^-1 R, which restores the R that the MAC's
    64-bit REDC divides out; forward and inverse twiddles, stage s's at
    offset N - (N >> s)) and the Garner constants [8] (p0, p1, n'0, n'1,
    inv(p0)*R mod p1, the mixed-radix digits of ceil(M/2), M mod 2^32)."""
    plans = [ntt.make_plan(n, p) for p in primes]
    tables = np.zeros((4, 2, n), dtype=np.uint32)
    for pi, pl in enumerate(plans):
        r = (1 << 32) % pl.ctx.p
        tables[0, pi] = pl.twist_fwd
        tables[1, pi] = pl.untwist_inv.astype(np.uint64) * r % pl.ctx.p
        tables[2, pi, :n - 1] = np.concatenate(pl.w_fwd)
        tables[3, pi, :n - 1] = np.concatenate(pl.w_inv)
    cc = crt.CrtContext.new(primes, 32)
    p0, p1 = primes
    consts = np.array(
        [p0, p1, plans[0].ctx.n_prime, plans[1].ctx.n_prime,
         cc.garner_inv[1] * ((1 << 32) % p1) % p1, *cc.half_digits,
         cc.m_mod_q], dtype=np.uint32)
    return tables.view(np.int32), consts.view(np.int32)


_DEVICE_TABLES: dict = {}


def _device_tables(n: int, primes: tuple, device) -> tuple:
    key = (n, primes, str(device))
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = tuple(torch.from_numpy(t).to(device)
                                    for t in _host_tables(n, primes))
    return _DEVICE_TABLES[key]


def ntt_cmux(cfg: ServerConfig, acc: torch.Tensor, a_hat: torch.Tensor,
             ggsw_i: torch.Tensor, *, out: torch.Tensor | None = None):
    """K9, one CMux step of the ntt blind rotation (ntt_cmux_plain) on the
    u32 torus with two CRT primes: acc [k+1, B, N] int32, a_hat [B] int32,
    ggsw_i [2, l, k+1, k+1, N] int32 Montgomery spectra (one step of
    bsk_to_ntt) -> the new acc, written into `out` when given (which must
    not be acc: other blocks still read a row while one writes it)."""
    ks1, b, n = acc.shape
    P = len(cfg.primes)
    _check(acc, "acc", torch.int32, (cfg.glwe_size, b, cfg.polynomial_size))
    _check(a_hat, "a_hat", torch.int32, (b,))
    _check(ggsw_i, "ggsw", torch.int32, (P, cfg.pbs_level, ks1, ks1, n))
    if out is not None:
        _check(out, "out", torch.int32, acc.shape)
    if _on_cpu(acc, a_hat, ggsw_i, out):
        res = ntt_cmux_plain(cfg, acc, a_hat, ggsw_i)
        return res if out is None else out.copy_(res)
    if not kernel_applies(cfg):
        raise ValueError("K9 takes the u32 torus with two CRT primes, got "
                         f"u{cfg.bits} with {P}")
    if n > N_MAX or n & (n - 1):
        raise ValueError(f"polynomial_size {n}: K9 takes powers of two up "
                         f"to {N_MAX}")
    if out is None:
        out = torch.empty_like(acc)
    if out.data_ptr() == acc.data_ptr():
        raise ValueError("out must not alias acc")
    if b:
        tables, consts = _device_tables(n, cfg.primes, acc.device)
        how, geometry = launch_geometry(ks1, n, cfg.pbs_level, b)
        _cuda.launch("ctt_ntt_cmux_warp" if how == "warp" else "ctt_ntt_cmux",
                     acc, a_hat, ggsw_i, tables, consts, out, b, ks1, n,
                     cfg.pbs_level, cfg.pbs_base_log, *geometry)
        _cuda.count_launch(ntt_cmux, B=b, ks1=ks1, N=n, l=cfg.pbs_level,
                           bl=cfg.pbs_base_log, path=how)
    return out


_cuda.counter(ntt_cmux)

KERNELS = (ntt_cmux,)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {k.__name__: k.launches for k in KERNELS}


def shape_counts() -> dict[str, dict[str, int]]:
    """Kernel launches per wrapper and shape key since the last reset."""
    return {k.__name__: dict(k.shapes) for k in KERNELS}


def reset_launch_counts():
    for k in KERNELS:
        _cuda.counter(k)


# ---------------------------------------------------------------------------
# blind rotation / bootstrap
# ---------------------------------------------------------------------------


def blind_rotate(cfg: ServerConfig, bsk_ntt: torch.Tensor, lut: torch.Tensor,
                 lwe: torch.Tensor, *, ms_offset: int = 0,
                 lut_count_log: int = 0) -> torch.Tensor:
    """Rotate `lut` by X^-b, then one CMux per mask element
    (fourier/mod.rs:666-726), bit-identical to concrete_tpu's blind_rotate.

    bsk_ntt [n, P, l, k+1, k+1, N] int32 (bsk_to_ntt); lut [..., k+1, N] and
    lwe [..., n+1] in the torus carrier. Returns the rotated accumulator
    [..., k+1, N]. Each step is K9 (ntt_cmux) where it applies, the u32
    torus with two primes, else the stacked composition (ntt_cmux_plain)."""
    n_lwe, N, ks1 = cfg.lwe_dimension, cfg.polynomial_size, cfg.glwe_size
    checks.check_bsk_ntt(bsk_ntt, cfg)
    if bsk_ntt.dtype != torch.int32:
        raise ValueError(f"bsk_ntt: int32 expected, got {bsk_ntt.dtype}")
    checks.check_lwe(lwe, n_lwe)
    checks.check_glwe(lut, ks1, N, "accumulator")
    if lwe.dtype != carrier(cfg.bits) or lut.dtype != lwe.dtype:
        raise TypeError(f"u{cfg.bits} torus tensors are {carrier(cfg.bits)}")
    lead = lwe.shape[:-1]
    acc, a_hats = rotation_start(lut, lwe, N, ms_offset, lut_count_log)
    if kernel_applies(cfg):
        spare = torch.empty_like(acc)
        for i in range(n_lwe):
            ntt_cmux(cfg, acc, a_hats[i], bsk_ntt[i], out=spare)
            acc, spare = spare, acc
    else:
        for i in range(n_lwe):
            acc = ntt_cmux_plain(cfg, acc, a_hats[i], bsk_ntt[i])
    return acc.transpose(0, 1).reshape(lead + (ks1, N))


def bootstrap(cfg: ServerConfig, bsk_ntt, lut, lwe) -> torch.Tensor:
    """Full PBS on the ntt backend (fourier/mod.rs:878-911):
    [..., n+1] -> [..., k*N+1]."""
    return sample_extract(blind_rotate(cfg, bsk_ntt, lut, lwe))


def bootstrap_many_lut(cfg: ServerConfig, bsk_ntt, lut, lwe,
                       lut_count_log: int, *, ms_offset: int = 0):
    """Multi-LUT PBS: one blind rotation, 2^lut_count_log extractions ->
    [2^lcl, ..., k*N+1]."""
    acc = blind_rotate(cfg, bsk_ntt, lut, lwe, ms_offset=ms_offset,
                       lut_count_log=lut_count_log)
    return torch.stack(
        [sample_extract_nth(acc, t) for t in range(1 << lut_count_log)], dim=0)


def bootstrap_keyswitch(cfg: ServerConfig, bsk_ntt, ksk8, lut, lwe):
    """PBS + keyswitch, the per-gate pipeline (server_key/mod.rs:133-166),
    against a limb-prepared keyswitch key (lwe.ksk_to_limbs; any ks_base_log,
    lwe.keyswitch_prepared): the same bits as concrete_tpu's u32 keyswitch,
    which its ntt gates take."""
    big = bootstrap(cfg, bsk_ntt, lut, lwe)
    return lwe_ops.keyswitch_prepared(ksk8, big, base_log=cfg.ks_base_log,
                                      level_count=cfg.ks_level)


@functools.lru_cache(maxsize=None)
def jit_bootstrap_keyswitch(cfg: ServerConfig) -> graphs.GraphedCall:
    """bootstrap_keyswitch for `cfg` in one dispatch, as concrete_tpu's
    jit_bootstrap_keyswitch (concrete_tpu/core/bootstrap.py, whose ntt PBS
    functions the port keeps here): fn(bsk_ntt, ksk8, lut, lwe), one CUDA
    graph per signature on CUDA tensors (ops/graphs.py; bsk_ntt and ksk8
    read where they lie, lut and lwe copied in), the eager function on CPU
    tensors. Both tori: K9 every step on u32, the torch composition on
    u64."""
    return graphs.GraphedCall(functools.partial(bootstrap_keyswitch, cfg), 2,
                              name="bootstrap_keyswitch")
