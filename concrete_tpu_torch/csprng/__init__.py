"""Forkable AES-128-CTR CSPRNG: the key, mask and noise streams.

The port's own copy of concrete_tpu's ``csprng`` (a redesign of
`concrete-csprng`): the same (aes_ctr, byte_ctr) state machine, 128-byte
batches of 8 AES blocks and fork-tree semantics (a counter range carved for
each child), so that equal seeds give the same keys, masks and noise as
concrete_tpu, byte for byte. AES runs in the native library
(:mod:`concrete_tpu_torch.native`).

    >>> SecretRandomGenerator(1).generate_binary_array(8).tolist()
    [0, 0, 0, 1, 1, 1, 0, 1]
"""

from .encryption import EncryptionRandomGenerator, SecretRandomGenerator
from .generator import AesCtrGenerator, State
from .random import RandomGenerator

__all__ = [
    "AesCtrGenerator",
    "State",
    "RandomGenerator",
    "EncryptionRandomGenerator",
    "SecretRandomGenerator",
]
