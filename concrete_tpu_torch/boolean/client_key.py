"""Client key: secret keys, encryption and decryption of booleans
(concrete-boolean/src/client_key/mod.rs).

true = +1/8 (1 << 29 on the u32 torus), false = -1/8 (7 << 29); decryption
is a sign test of the phase. Keys and ciphertexts are np.uint32; decrypt
also takes the int32 tensors the server returns.

Keys, masks and noise come from the AES-CTR streams seeded with
`secret_seed`, `mask_seed` and `noise_seed`: equal seeds give concrete_tpu's
keys and ciphertexts, byte for byte. Keys saved by ``concrete_tpu`` load
here unchanged (`load`).

Example:
    >>> from concrete_tpu_torch.params import BooleanParameters
    >>> from concrete_tpu_torch.dispersion import StandardDev
    >>> tiny = BooleanParameters(4, 1, 16, StandardDev(0.0), StandardDev(0.0), 7, 2, 2, 2)
    >>> cks = ClientKey.new(tiny, secret_seed=1)
    >>> ct = cks.encrypt([True, False], mask_seed=2, noise_seed=3)
    >>> cks.decrypt(ct).tolist(), cks.lwe_secret_key.key.tolist(), int(ct[0, -1])
    ([True, False], [0, 0, 0, 1], 1097489848)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.glwe import GlweSecretKey
from ..core.lwe import LweSecretKey
from ..csprng import EncryptionRandomGenerator, SecretRandomGenerator
from ..dispersion import StandardDev
from ..params import BooleanParameters
from ..torus import to_numpy

PLAINTEXT_LOG_SCALING_FACTOR = 3
PLAINTEXT_TRUE = 1 << (32 - PLAINTEXT_LOG_SCALING_FACTOR)              # +1/8
PLAINTEXT_FALSE = (7 << (32 - PLAINTEXT_LOG_SCALING_FACTOR)) & 0xFFFFFFFF  # -1/8


@dataclasses.dataclass
class ClientKey:
    """LWE + GLWE binary secret keys (client_key/mod.rs:113)."""

    lwe_secret_key: LweSecretKey
    glwe_secret_key: GlweSecretKey
    parameters: BooleanParameters

    @classmethod
    def new(cls, parameters: BooleanParameters, *,
            secret_seed: int | None = None) -> "ClientKey":
        gen = SecretRandomGenerator(secret_seed)
        lwe_sk = LweSecretKey.generate_binary(parameters.lwe_dimension, gen)
        glwe_sk = GlweSecretKey.generate_binary(
            parameters.glwe_dimension, parameters.polynomial_size, gen)
        return cls(lwe_secret_key=lwe_sk, glwe_secret_key=glwe_sk,
                   parameters=parameters)

    def encrypt(self, messages, *, mask_seed: int | None = None,
                noise_seed: int | None = None) -> np.ndarray:
        """Encrypt a (batch of) boolean(s) -> [..., n+1] np.uint32
        (client_key/mod.rs:49-72)."""
        msgs = np.asarray(messages, dtype=bool)
        plain = np.where(msgs, PLAINTEXT_TRUE, PLAINTEXT_FALSE).astype(np.uint32)
        return self.lwe_secret_key.encrypt(
            plain, self.parameters.lwe_modular_std_dev.std_dev,
            EncryptionRandomGenerator(mask_seed, noise_seed))

    def decrypt(self, ciphertexts) -> np.ndarray:
        """Decrypt np.uint32 arrays or int32 tensors -> bool array (sign
        test, client_key/mod.rs:91-100)."""
        phase = self.lwe_secret_key.decrypt(to_numpy(ciphertexts))
        return phase < np.uint32(1 << 31)

    def save(self, path: str):
        """Serialize in the npz format of concrete_tpu's ClientKey.save."""
        p = self.parameters
        np.savez_compressed(
            path,
            lwe_key=self.lwe_secret_key.key,
            glwe_key=self.glwe_secret_key.key,
            params=np.array([p.lwe_dimension, p.glwe_dimension,
                             p.polynomial_size, p.pbs_base_log, p.pbs_level,
                             p.ks_base_log, p.ks_level]),
            stds=np.array([p.lwe_modular_std_dev.std_dev,
                           p.glwe_modular_std_dev.std_dev]),
        )

    @classmethod
    def load(cls, path: str) -> "ClientKey":
        """Read a key written by `save` or by concrete_tpu's ClientKey.save."""
        with np.load(path, allow_pickle=False) as d:
            p, stds = d["params"], d["stds"]
            params = BooleanParameters(
                lwe_dimension=int(p[0]),
                glwe_dimension=int(p[1]),
                polynomial_size=int(p[2]),
                lwe_modular_std_dev=StandardDev(float(stds[0])),
                glwe_modular_std_dev=StandardDev(float(stds[1])),
                pbs_base_log=int(p[3]),
                pbs_level=int(p[4]),
                ks_base_log=int(p[5]),
                ks_level=int(p[6]),
            )
            return cls(
                lwe_secret_key=LweSecretKey(d["lwe_key"].astype(np.uint32),
                                            "binary", 32),
                glwe_secret_key=GlweSecretKey(d["glwe_key"].astype(np.uint32),
                                              "binary", 32),
                parameters=params,
            )

    def decrypt_big_key(self, ciphertexts) -> np.ndarray:
        """Decrypt under the flattened GLWE ("big") key -> bool array: the
        key of the bootstrap's output before the keyswitch."""
        big = self.glwe_secret_key.into_lwe_key()
        return big.decrypt(to_numpy(ciphertexts)) < np.uint32(1 << 31)
