"""GLWE secret keys, encryption and decryption (crypto/secret/glwe.rs).

A GLWE ciphertext is [k+1, N] with the body polynomial last. Keys and
ciphertexts are np.uint32 (u32 torus) or np.uint64 (u64 torus). Masks and
noise come from the AES-CTR streams of :mod:`concrete_tpu_torch.csprng` in
concrete_tpu's order (noise first, then the masks), so equal seeds give the
same bytes. The mask-times-key products run through
``math.polynomial.negacyclic_multisum`` (exact for every key kind, float64),
on a device of the caller's choice (the CPU by default; the card for key
generation at full width): every device gives the same bytes.

Example:
    >>> import numpy as np
    >>> from concrete_tpu_torch.csprng import EncryptionRandomGenerator, SecretRandomGenerator
    >>> sk = GlweSecretKey.generate_binary(2, 8, SecretRandomGenerator(1))
    >>> sk.key.shape, sk.into_lwe_key().dimension, sk.key[0].tolist()
    ((2, 8), 16, [0, 0, 0, 1, 1, 1, 0, 1])
    >>> ct = sk.encrypt(np.arange(8, dtype=np.uint32) << 28, 0.0,
    ...                 EncryptionRandomGenerator(2, 3))
    >>> ct.shape, (sk.decrypt(ct) >> 28).tolist()
    ((3, 8), [0, 1, 2, 3, 4, 5, 6, 7])
    >>> GlweSecretKey.generate_ternary(1, 8, SecretRandomGenerator(1), bits=64).key.dtype
    dtype('uint64')
    >>> primes = (2013265921, 1811939329)   # two NTT primes = 1 mod 2N
    >>> spec = glwe_to_ntt(ct, primes, 32)
    >>> spec.shape, np.array_equal(to_numpy(glwe_from_ntt(spec, primes, 32)), ct)
    (torch.Size([2, 3, 8]), True)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..csprng import EncryptionRandomGenerator, SecretRandomGenerator
from ..math import crt, ntt, polynomial
from ..torus import UNSIGNED, as_torus, carrier, from_numpy, to_numpy


@dataclasses.dataclass
class GlweSecretKey:
    """A GLWE secret key: [k, N] np.uint32 / np.uint64 key polynomials
    (secret/glwe.rs:31); `kind` is binary, ternary, gaussian or uniform and
    `bits` the torus width."""

    key: np.ndarray
    kind: str = "binary"
    bits: int = 32

    @property
    def dimension(self) -> int:
        return self.key.shape[0]

    @property
    def polynomial_size(self) -> int:
        return self.key.shape[1]

    @classmethod
    def _generate(cls, kind: str, dim: int, poly_size: int,
                  gen: SecretRandomGenerator, bits: int):
        draw = getattr(gen, f"generate_{kind}_array")
        return cls(draw(dim * poly_size, bits).reshape(dim, poly_size), kind,
                   bits)

    @classmethod
    def generate_binary(cls, dim: int, poly_size: int,
                        gen: SecretRandomGenerator, bits: int = 32):
        return cls._generate("binary", dim, poly_size, gen, bits)

    @classmethod
    def generate_ternary(cls, dim: int, poly_size: int,
                         gen: SecretRandomGenerator, bits: int = 32):
        return cls._generate("ternary", dim, poly_size, gen, bits)

    @classmethod
    def generate_gaussian(cls, dim: int, poly_size: int,
                          gen: SecretRandomGenerator, bits: int = 32):
        return cls._generate("gaussian", dim, poly_size, gen, bits)

    @classmethod
    def generate_uniform(cls, dim: int, poly_size: int,
                         gen: SecretRandomGenerator, bits: int = 32):
        return cls._generate("uniform", dim, poly_size, gen, bits)

    def into_lwe_key(self):
        """The flattened ("big") LWE key of dimension k*N (secret/glwe.rs:332),
        which decrypts sample-extracted ciphertexts."""
        from .lwe import LweSecretKey

        return LweSecretKey(self.key.reshape(-1).copy(), self.kind, self.bits)

    # -- encryption ----------------------------------------------------------

    def multisum(self, masks, device=None) -> torch.Tensor:
        """sum_j masks[..., j, :] * s_j mod (X^N + 1, 2^bits) as a carrier
        tensor on `device` (numpy or tensor masks [..., k, N])."""
        return polynomial.negacyclic_multisum(
            as_torus(masks, device, self.bits),
            from_numpy(self.key, device, self.bits))

    def encrypt_from_randomness(self, masks: np.ndarray, noises: np.ndarray,
                                msgs: np.ndarray, device=None) -> np.ndarray:
        """Ciphertexts from pre-drawn randomness: masks [..., k, N], noises
        and msgs [..., N] -> [..., k+1, N] with body = noise + sum_j a_j*s_j
        + msg (secret/glwe.rs:488-516); the products run on `device`."""
        bodies = noises + to_numpy(self.multisum(masks, device)) + msgs
        return np.concatenate([masks, bodies[..., None, :]], axis=-2)

    def draw_randomness(self, count: int, std: float,
                        gen: EncryptionRandomGenerator):
        """The stream order of one ciphertext after another
        (secret/glwe.rs:488-516): Gaussian noise for the body first (noise
        stream), then k mask polynomials (mask stream). N is even, so the
        batched pairs consume what the per-ciphertext loop does."""
        k, n = self.dimension, self.polynomial_size
        assert n % 2 == 0
        noises = gen.fill_noise(count * n, std, self.bits).reshape(count, n)
        masks = gen.fill_mask(count * k * n, self.bits).reshape(count, k, n)
        return masks, noises

    def encrypt(self, messages, std: float, gen: EncryptionRandomGenerator,
                device=None) -> np.ndarray:
        """Encrypt message polynomials [..., N] -> [..., k+1, N]."""
        dt = UNSIGNED[self.bits]
        k, n = self.dimension, self.polynomial_size
        msgs = np.asarray(messages, dtype=dt)
        lead = msgs.shape[:-1]
        count = int(np.prod(lead, dtype=np.int64)) if lead else 1
        masks, noises = self.draw_randomness(count, std, gen)
        out = self.encrypt_from_randomness(masks, noises,
                                           msgs.reshape(count, n), device)
        return out.reshape(lead + (k + 1, n))

    def encrypt_zero(self, count_shape, std: float,
                     gen: EncryptionRandomGenerator, device=None) -> np.ndarray:
        """Fresh encryptions of zero (secret/glwe.rs:547)."""
        zeros = np.zeros(tuple(count_shape) + (self.polynomial_size,),
                         dtype=UNSIGNED[self.bits])
        return self.encrypt(zeros, std, gen, device)

    def decrypt(self, ct, device=None) -> np.ndarray:
        """body - sum_j a_j*s_j (secret/glwe.rs:694), unsigned."""
        ct = to_numpy(ct) if isinstance(ct, torch.Tensor) else \
            np.asarray(ct, dtype=UNSIGNED[self.bits])
        return (ct[..., -1, :] - to_numpy(self.multisum(ct[..., :-1, :], device))
                ).astype(UNSIGNED[self.bits])


def trivial_encrypt(poly, glwe_dimension: int, bits: int = 32,
                    device=None) -> torch.Tensor:
    """Trivial GLWE: zero masks, body = the plaintext polynomial
    (glwe_ciphertext_trivial_encryption): [..., N] -> [..., k+1, N] in the
    torus carrier."""
    poly = as_torus(poly, device, bits)
    out = torch.zeros(poly.shape[:-1] + (glwe_dimension + 1, poly.shape[-1]),
                      dtype=carrier(bits), device=poly.device)
    out[..., -1, :] = poly
    return out


def trivial_decrypt(ct: torch.Tensor) -> torch.Tensor:
    """The body polynomial of a trivial GLWE."""
    return ct[..., -1, :]


# ---------------------------------------------------------------------------
# NTT-domain GLWE (FourierGlweCiphertext analog, crypto/glwe/fourier.rs:18)
# ---------------------------------------------------------------------------


def glwe_to_ntt(glwe, primes: tuple[int, ...], bits: int, *,
                device=None) -> torch.Tensor:
    """Forward-NTT every polynomial of a GLWE tensor [..., N] (u32 / u64
    torus) -> [P, ..., N] Montgomery spectra in bit-reversed order, u32
    words as int32 (values below 2^31), concrete_tpu's glwe_to_ntt bit for
    bit. Coefficients are centered (signed) before the residue reduction,
    the analog of the reference's standard -> Fourier conversion. Runs on
    `device`, else the tensor's own, else the CPU for numpy input."""
    g = as_torus(glwe, device, bits)
    primes = tuple(primes)
    residues = crt.CrtContext.new(primes, bits).residues_from_torus(g)
    sp = ntt.make_stacked_plans(g.shape[-1], primes)
    return ntt.forward_stacked(sp, torch.stack(residues)).to(torch.int32)


def glwe_from_ntt(spectra: torch.Tensor, primes: tuple[int, ...],
                  bits: int) -> torch.Tensor:
    """Inverse of glwe_to_ntt: [P, ..., N] spectra -> the torus carrier
    [..., N] (int32 / int64), on the spectra's device."""
    primes = tuple(primes)
    sp = ntt.make_stacked_plans(spectra.shape[-1], primes)
    residues = ntt.inverse_stacked(sp, spectra)
    return crt.CrtContext.new(primes, bits).combine_to_torus(list(residues))
