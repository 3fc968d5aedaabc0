"""Boolean gates with gate bootstrapping, batched (the concrete-boolean API).

Booleans encode as +-1/8 on the u32 torus; every binary gate is one linear
combination, a PBS and a keyswitch; NOT is a free negation; MUX costs two
PBS. Ciphertext arrays [..., n+1] evaluate whole gate vectors per call.
"""

from ..params import DEFAULT_PARAMETERS, TFHE_LIB_PARAMETERS, BooleanParameters
from .client_key import PLAINTEXT_FALSE, PLAINTEXT_TRUE, ClientKey
from .server_key import ServerKey


def gen_keys(parameters: BooleanParameters = DEFAULT_PARAMETERS, *,
             secret_seed: int | None = None, mask_seed: int | None = None,
             noise_seed: int | None = None, device=None):
    """Generate a (client, server) key pair (concrete-boolean/src/lib.rs:96);
    fixing all three seeds makes key generation reproducible. The server key
    lives on `device` (default: the GPU; without one, pass device="cpu").

    >>> from concrete_tpu_torch.params import BooleanParameters
    >>> from concrete_tpu_torch.dispersion import StandardDev
    >>> tiny = BooleanParameters(4, 1, 16, StandardDev(0.0), StandardDev(0.0), 7, 2, 2, 2)
    >>> cks, sks = gen_keys(tiny, secret_seed=1, mask_seed=2, noise_seed=3, device="cpu")
    >>> sks.bsk_standard.shape, sks.resolved_backend()
    ((4, 2, 2, 2, 16), 'ntt')
    """
    cks = ClientKey.new(parameters, secret_seed=secret_seed)
    sks = ServerKey.new(cks, mask_seed=mask_seed, noise_seed=noise_seed,
                        device=device)
    return cks, sks


__all__ = [
    "gen_keys",
    "ClientKey",
    "ServerKey",
    "BooleanParameters",
    "DEFAULT_PARAMETERS",
    "TFHE_LIB_PARAMETERS",
    "PLAINTEXT_TRUE",
    "PLAINTEXT_FALSE",
]
