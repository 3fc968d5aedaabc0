"""Plain TFHE on the u32 and u64 torus, written from concrete-core's
definitions and independent of the program: the benchmark's input generator
(secret keys, the standard bootstrapping and keyswitching keys, LWE
encryptions) and its reference (modulus switch, blind rotation, sample
extraction, keyswitch, decryption).

Torus values ride int64 tensors: a u32 value in [0, 2^32), a u64 value as
its two's-complement bit pattern (wrapping adds, multiplies and left shifts
are the u64 ones). Every polynomial product is a negacyclic matrix product
in float64 on 32-bit limbs, sized so that each partial sum stays an exact
integer below 2^53 (`limb_bits`), so the results are exact mod 2^bits
whatever the summation order, on the CPU and on the card.

Layouts, as the program takes them: a bootstrapping key [n, l, k+1, k+1, N]
(key bit, level 1 first, GGSW row, GLWE polynomial, coefficient); a
keyswitching key [k*N, l_ks, n+1]; an LWE ciphertext [..., n+1], body last.
"""

from __future__ import annotations

import math

import torch

I64 = torch.int64
F64 = torch.float64


def wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    """x mod 2^bits (u32 values kept in [0, 2^32); u64 wraps by itself)."""
    return x & 0xFFFFFFFF if bits == 32 else x


def lshr(x: torch.Tensor, s: int, bits: int) -> torch.Tensor:
    """Logical right shift of torus values."""
    if s == 0 or bits == 32:
        return x >> s
    return (x >> s) & ((1 << (64 - s)) - 1)


def limb_bits(digit_max: int, terms: int) -> int:
    """Width of the key limbs of a float64 product whose `terms` products
    each have a factor of at most `digit_max` in magnitude: every partial
    sum stays below 2^52."""
    return min(32, 52 - math.ceil(math.log2(digit_max + 1))
               - math.ceil(math.log2(terms)))


def to_limbs(x: torch.Tensor, bits: int, width: int) -> list[torch.Tensor]:
    """Unsigned `width`-bit limbs of torus values, least significant first,
    as float64."""
    return [(lshr(x, width * i, bits) & ((1 << width) - 1)).to(F64)
            for i in range(math.ceil(bits / width))]


def from_limbs(parts: list[torch.Tensor], bits: int, width: int):
    """sum_i parts[i] * 2^(width*i) mod 2^bits from exact float64 limb sums."""
    out = torch.zeros(parts[0].shape, dtype=I64, device=parts[0].device)
    for i, part in enumerate(parts):
        out = out + (torch.round(part).to(I64) << (width * i))
    return wrap(out, bits)


def negacyclic_matrix(poly: torch.Tensor) -> tuple:
    """(index, sign) with poly[..., index] * sign = T, the [N, N] matrix of
    the product by `poly` in Z[X]/(X^N + 1): (a * p)_j = sum_i a_i T[i, j]."""
    n = poly.shape[-1]
    i = torch.arange(n, device=poly.device)
    diff = i[None, :] - i[:, None]
    return diff % n, torch.where(diff >= 0, 1.0, -1.0).to(F64)


def negacyclic_dot(digits: torch.Tensor, polys: torch.Tensor, bits: int,
                   digit_max: int) -> torch.Tensor:
    """sum_r digits[b, r] * polys[r, c] in (Z/2^bits)[X]/(X^N + 1): small
    signed digit polynomials [B, R, N] (|d| <= digit_max) times torus
    polynomials [R, C, N] -> [B, C, N]."""
    bsz, r, n = digits.shape
    c = polys.shape[1]
    width = limb_bits(digit_max, r * n)
    idx, sign = negacyclic_matrix(polys)
    lhs = digits.reshape(bsz, r * n).to(F64)
    parts = []
    for limb in to_limbs(polys, bits, width):
        mat = limb[..., idx] * sign                  # [R, C, N(i), N(j)]
        mat = mat.permute(0, 2, 1, 3).reshape(r * n, c * n)
        parts.append((lhs @ mat).reshape(bsz, c, n))
    return from_limbs(parts, bits, width)


def mask_key_products(masks: torch.Tensor, key: torch.Tensor,
                      bits: int) -> torch.Tensor:
    """sum_j masks[..., j, :] * key[j, :] mod (X^N + 1, 2^bits) for uniform
    masks [..., k, N] and a binary key [k, N]: the body of a GLWE
    encryption (the key's entries are the small factor)."""
    lead = masks.shape[:-2]
    k, n = key.shape
    flat = masks.reshape(-1, k, n)
    width = limb_bits(1, k * n)
    idx, sign = negacyclic_matrix(key)
    mat = (key.to(F64)[:, idx] * sign).reshape(k * n, n)
    parts = [limb.reshape(-1, k * n) @ mat
             for limb in to_limbs(flat, bits, width)]
    return from_limbs(parts, bits, width).reshape(lead + (n,))


def inner_products(masks: torch.Tensor, key: torch.Tensor, bits: int):
    """<masks[..., :], key> mod 2^bits for a binary key [n]."""
    width = limb_bits(1, key.shape[0])
    parts = [limb @ key.to(F64) for limb in to_limbs(masks, bits, width)]
    return from_limbs(parts, bits, width)


# ---------------------------------------------------------------------------
# input generation (client side)
# ---------------------------------------------------------------------------


def uniform(gen: torch.Generator, shape, bits: int, device) -> torch.Tensor:
    """Uniform torus values."""
    lo = torch.randint(0, 1 << 32, shape, generator=gen, device=device,
                       dtype=I64)
    if bits == 32:
        return lo
    hi = torch.randint(0, 1 << 32, shape, generator=gen, device=device,
                       dtype=I64)
    return lo | (hi << 32)


def gaussian(gen: torch.Generator, shape, std: float, bits: int, device):
    """Centred Gaussian torus noise of standard deviation `std` (a fraction
    of the torus), rounded to the torus grid."""
    e = torch.randn(shape, generator=gen, device=device, dtype=F64)
    return wrap(torch.round(e * (std * 2.0 ** bits)).to(I64), bits)


def binary_key(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randint(0, 2, shape, generator=gen, device=device, dtype=I64)


def lwe_encrypt(gen, key: torch.Tensor, plaintexts: torch.Tensor, std: float,
                bits: int) -> torch.Tensor:
    """LWE encryptions [..., n+1] of torus plaintexts under a binary key:
    uniform mask, body <a, s> + e + m."""
    lead = plaintexts.shape
    n = key.shape[0]
    masks = uniform(gen, lead + (n,), bits, key.device)
    noise = gaussian(gen, lead, std, bits, key.device)
    body = wrap(inner_products(masks, key, bits) + noise + plaintexts, bits)
    return torch.cat([masks, body[..., None]], dim=-1)


def bootstrap_key(gen, lwe_key: torch.Tensor, glwe_key: torch.Tensor,
                  base_log: int, level: int, std: float,
                  bits: int) -> torch.Tensor:
    """GGSW encryptions of the LWE key bits under the GLWE key, [n, l, k+1,
    k+1, N]: row r of level j is a GLWE encryption of zero plus s_i *
    q/B^j on polynomial r (the mask polynomial r, the body for r = k)."""
    n = lwe_key.shape[0]
    k, big_n = glwe_key.shape
    dev = lwe_key.device
    masks = uniform(gen, (n, level, k + 1, k, big_n), bits, dev)
    noise = gaussian(gen, (n, level, k + 1, big_n), std, bits, dev)
    body = wrap(mask_key_products(masks, glwe_key, bits) + noise, bits)
    out = torch.cat([masks, body[..., None, :]], dim=-2)
    shifts = torch.tensor([bits - base_log * (j + 1) for j in range(level)],
                          device=dev)
    gadget = wrap(lwe_key[:, None] << shifts[None, :], bits)     # [n, l]
    for r in range(k + 1):
        out[:, :, r, r, 0] = wrap(out[:, :, r, r, 0] + gadget, bits)
    return out


def keyswitch_key(gen, key_in: torch.Tensor, key_out: torch.Tensor,
                  base_log: int, level: int, std: float,
                  bits: int) -> torch.Tensor:
    """[n_in, l, n_out+1]: LWE encryptions of s_in[i] * q/B^j under key_out."""
    shifts = torch.tensor([bits - base_log * (j + 1) for j in range(level)],
                          device=key_in.device)
    msgs = wrap(key_in[:, None] << shifts[None, :], bits)
    return lwe_encrypt(gen, key_out, msgs, std, bits)


def lwe_phase(key: torch.Tensor, cts: torch.Tensor, bits: int):
    """b - <a, s> mod 2^bits."""
    return wrap(cts[..., -1] - inner_products(cts[..., :-1], key, bits), bits)


# ---------------------------------------------------------------------------
# the server side: PBS and keyswitch (the reference)
# ---------------------------------------------------------------------------


def modulus_switch(x: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """round(x * 2N / 2^bits) mod 2N, halves rounded up."""
    log2n = n.bit_length() - 1
    return ((lshr(x, bits - log2n - 2, bits) + 1) >> 1) % (2 * n)


def rotate(polys: torch.Tensor, degree: torch.Tensor, bits: int):
    """polys [B, C, N] times X^degree[b] mod X^N + 1, degree in [0, 2N)."""
    n = polys.shape[-1]
    j = torch.arange(n, device=polys.device)
    t = (j[None, :] - degree[:, None]) % (2 * n)
    neg = t >= n
    src = torch.where(neg, t - n, t)[:, None, :].expand(polys.shape)
    out = torch.gather(polys, 2, src)
    return wrap(torch.where(neg[:, None, :], -out, out), bits)


def gadget_digits(x: torch.Tensor, base_log: int, level: int, bits: int):
    """The external product's signed digits [..., l] (level 1 first): x
    rounded half up to its top base_log*level bits (a value that rounds up
    to q wraps to 0), then digits in [-B/2, B/2] from the least significant
    up; a digit above B/2, or equal to B/2 when the next digit's top bit is
    set, carries one into the next (concrete-core's decomposer)."""
    width = base_log * level
    state = ((lshr(x, bits - width - 1, bits) + 1) >> 1) & ((1 << width) - 1)
    base, half = 1 << base_log, 1 << (base_log - 1)
    out = [None] * level
    for step in range(level):
        res = state & (base - 1)
        state = state >> base_log
        carry = ((res > half) | ((res == half)
                                 & (((state >> (base_log - 1)) & 1) == 1))
                 ).to(I64)
        state = state + carry
        out[level - 1 - step] = res - carry * base
    return torch.stack(out, dim=-1)


def keyswitch_digits(x: torch.Tensor, base_log: int, level: int, bits: int):
    """The keyswitch's signed digits [..., l] (level 1 first) of x rounded
    half up to its top base_log*level bits: blocks from the least
    significant up, each plus the carry out of the one below; a block whose
    own top bit, or whose top bit after the carry, is set gives a digit
    minus B and carries one (concrete-core's small-sign decomposition)."""
    width = base_log * level
    rounded = ((lshr(x, bits - width - 1, bits) + 1) >> 1) & ((1 << width) - 1)
    base, half = 1 << base_log, 1 << (base_log - 1)
    carry = torch.zeros_like(x)
    out = [None] * level
    for i in reversed(range(level)):
        block = (rounded >> (base_log * (level - 1 - i))) & (base - 1)
        top = block & half
        block = block + carry
        top = top | (block & half)
        out[i] = block - (top << 1)
        carry = top >> (base_log - 1)
    return torch.stack(out, dim=-1)


def blind_rotate(bsk: torch.Tensor, luts: torch.Tensor, lwe: torch.Tensor,
                 base_log: int, level: int, bits: int) -> torch.Tensor:
    """The accumulator [B, k+1, N] after rotating each row's test
    polynomial luts [B, k+1, N] by X^-b and one CMux a mask element:
    acc += bsk_i (x) (X^a_i acc - acc)."""
    n_lwe = bsk.shape[0]
    ks1, big_n = bsk.shape[-2], bsk.shape[-1]
    a = modulus_switch(lwe[:, :-1], big_n, bits)
    b = modulus_switch(lwe[:, -1], big_n, bits)
    acc = rotate(luts, (2 * big_n - b) % (2 * big_n), bits)
    half = 1 << (base_log - 1)
    for i in range(n_lwe):
        diff = wrap(rotate(acc, a[:, i], bits) - acc, bits)
        digits = gadget_digits(diff, base_log, level, bits)   # [B, k+1, N, l]
        digits = digits.permute(0, 1, 3, 2).reshape(
            acc.shape[0], ks1 * level, big_n)
        # GGSW rows in the digits' order: (row r, level j)
        ggsw = bsk[i].transpose(0, 1).reshape(ks1 * level, ks1, big_n)
        acc = wrap(acc + negacyclic_dot(digits, ggsw, bits, half), bits)
    return acc


def sample_extract(acc: torch.Tensor, bits: int) -> torch.Tensor:
    """LWE [B, k*N+1] of coefficient 0 of the GLWE [B, k+1, N]:
    a'[r*N] = a_r[0], a'[r*N + i] = -a_r[N - i], b' = b[0]."""
    mask = acc[:, :-1, :]
    out = torch.cat([mask[..., :1], wrap(-mask[..., 1:].flip(-1), bits)],
                    dim=-1)
    return torch.cat([out.reshape(acc.shape[0], -1), acc[:, -1, :1]], dim=-1)


def keyswitch(ksk: torch.Tensor, cts: torch.Tensor, base_log: int,
              level: int, bits: int) -> torch.Tensor:
    """[B, n_in+1] -> [B, n_out+1]: (0, b) - sum_ij d_ij ksk[i, j]."""
    bsz = cts.shape[0]
    n_in = cts.shape[-1] - 1
    digits = keyswitch_digits(cts[:, :-1], base_log, level, bits)
    lhs = digits.reshape(bsz, n_in * level).to(F64)
    rows = ksk.reshape(n_in * level, -1)
    width = limb_bits(1 << (base_log - 1), n_in * level)
    prod = from_limbs([lhs @ limb for limb in to_limbs(rows, bits, width)],
                      bits, width)
    out = wrap(-prod, bits)
    out[:, -1] = wrap(out[:, -1] + cts[:, -1], bits)
    return out


def in_blocks(fn, rows: int, block: int, *tensors):
    """fn over blocks of `block` rows of the tensors, concatenated."""
    return torch.cat([fn(*(t[s:s + block] for t in tensors))
                      for s in range(0, rows, block)])
