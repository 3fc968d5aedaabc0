"""High-level user API: encoders, noise-tracked LWE, function bootstrapping.

The analog of the reference's `concrete` crate (concrete/src/): real-interval
encoders with padding bits, per-ciphertext noise-variance tracking through
the NPE after every operation, keyswitching, programmable bootstrapping with
arbitrary f64 -> f64 functions, and serialization. Torus is u64 here
(concrete/src/lib.rs:22), giving 64-bit noise headroom.

Batch-first redesign: `LWE` carries a ciphertext *batch* of any shape with a
shared encoder; `VectorLWE` mirrors the reference's per-slot-encoder
semantics; `VectorRLWE` packs N messages per RLWE ciphertext. The port of
concrete_tpu/highlevel: bootstrap and keyswitch run on the keys' device
(the GPU unless device="cpu").
"""

from .encoder import Encoder
from .errors import (
    CryptoAPIError,
    DeltaError,
    DimensionError,
    InvalidEncoderError,
    MessageOutsideIntervalError,
    MinMaxError,
    NoNoiseInCiphertext,
    NotEnoughPaddingError,
    PaddingError,
    PrecisionError,
    ZeroInIntervalError,
)
from .keys import LWEBSK, LWEKSK, LWESecretKey, RLWESecretKey
from .lwe import LWE
from .plaintext import Plaintext
from .vector_lwe import VectorLWE
from .vector_rlwe import VectorRLWE
from .params_presets import (
    LWEParams,
    RLWEParams,
    LWE128_256,
    LWE128_512,
    LWE128_630,
    LWE128_650,
    LWE128_688,
    LWE128_710,
    LWE128_750,
    LWE128_800,
    LWE128_830,
    LWE128_1024,
    LWE128_2048,
    LWE128_4096,
    LWE80_256,
    LWE80_512,
    LWE80_630,
    LWE80_650,
    LWE80_688,
    LWE80_1024,
    LWE80_2048,
    RLWE128_256_1,
    RLWE128_512_1,
    RLWE128_1024_1,
    RLWE128_2048_1,
    RLWE128_4096_1,
    RLWE128_256_2,
    RLWE128_512_2,
    RLWE128_256_4,
    RLWE80_1024_1,
    RLWE80_2048_1,
)

__all__ = [
    "Encoder", "LWE", "Plaintext", "VectorLWE", "VectorRLWE",
    "LWESecretKey", "RLWESecretKey", "LWEBSK", "LWEKSK",
    "LWEParams", "RLWEParams", "CryptoAPIError",
    "DimensionError", "DeltaError", "PaddingError", "PrecisionError",
    "MinMaxError", "MessageOutsideIntervalError", "InvalidEncoderError",
    "NotEnoughPaddingError", "NoNoiseInCiphertext", "ZeroInIntervalError",
    "LWE128_256", "LWE128_512", "LWE128_630", "LWE128_650", "LWE128_688",
    "LWE128_710", "LWE128_750", "LWE128_800", "LWE128_830", "LWE128_1024",
    "LWE128_2048", "LWE128_4096",
    "LWE80_256", "LWE80_512", "LWE80_630", "LWE80_650", "LWE80_688",
    "LWE80_1024", "LWE80_2048",
    "RLWE128_256_1", "RLWE128_512_1", "RLWE128_1024_1", "RLWE128_2048_1",
    "RLWE128_4096_1", "RLWE128_256_2", "RLWE128_512_2", "RLWE128_256_4",
    "RLWE80_1024_1", "RLWE80_2048_1",
]
