"""User-facing error types, mirroring the reference's CryptoAPIError variants
(concrete/src/error.rs:4, message macros :242-381).
Example:
    >>> from concrete_tpu_torch.highlevel import errors
    >>> issubclass(errors.DimensionError, errors.CryptoAPIError)
    True
"""


class CryptoAPIError(Exception):
    """Base class for all user-API errors."""


class MinMaxError(CryptoAPIError):
    def __init__(self, mn, mx):
        super().__init__(f"min ({mn}) >= max ({mx})")


class PrecisionError(CryptoAPIError):
    def __init__(self):
        super().__init__("the number of bits of precision must be > 0")


class MessageOutsideIntervalError(CryptoAPIError):
    def __init__(self, m, o, delta):
        super().__init__(f"message {m} outside interval [{o}, {o + delta})")


class InvalidEncoderError(CryptoAPIError):
    def __init__(self, nb_bit_precision, delta):
        super().__init__(
            f"invalid encoder: nb_bit_precision={nb_bit_precision}, delta={delta}"
        )


class DimensionError(CryptoAPIError):
    def __init__(self, d1, d2):
        super().__init__(f"LWE dimensions differ: {d1} != {d2}")


class DeltaError(CryptoAPIError):
    def __init__(self, d1, d2):
        super().__init__(f"encoder deltas differ: {d1} != {d2}")


class PaddingError(CryptoAPIError):
    def __init__(self, p1, p2):
        super().__init__(f"padding mismatch: {p1} != {p2}")


class NotEnoughPaddingError(CryptoAPIError):
    def __init__(self, got, need):
        super().__init__(f"not enough padding: have {got}, need {need}")


class NoNoiseInCiphertext(CryptoAPIError):
    def __init__(self, var):
        super().__init__(f"no noise in ciphertext (variance {var})")


class ZeroInIntervalError(CryptoAPIError):
    def __init__(self, o, delta):
        super().__init__(f"interval [{o}, {o + delta}) must contain zero")


class ConstantMaximumError(CryptoAPIError):
    def __init__(self, c, mx):
        super().__init__(f"|constant {c}| exceeds max_constant {mx}")


class IndexError_(CryptoAPIError):
    def __init__(self, msg):
        super().__init__(msg)
