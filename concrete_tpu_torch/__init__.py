"""concrete-tpu-torch: the PyTorch/CUDA port of concrete-tpu (TFHE over the
discretized torus), for NVIDIA Hopper GPUs.

The JAX package ``concrete_tpu`` is the reference: every server-side op here
is exact integer arithmetic mod 2^32 and is held bit for bit against it.
This package imports torch and numpy, never jax. The kernels that the JAX
package writes in Pallas for the TPU are hand-written CUDA C++ here
(``csrc/``), built at first use on a CUDA machine; on CPU tensors their
plain PyTorch versions run instead.

Ported so far: the boolean gates (``concrete_tpu_torch.boolean``, u32
torus) and the high-level API (``concrete_tpu_torch.highlevel``, u64 torus,
``VectorRLWE`` included) through the toeplitz ("mxu"), Nussbaumer ("nuss")
and exact-NTT ("ntt") backends of the bootstrap; the client side
(``csprng``); the conformance harness (``fixtures``, ``testing``), the
parameter co-design (``design``), the roofline and timing helpers
(``profiling``) and the device probe (``diagnose``).
"""

from . import dispersion, params  # noqa: F401

__version__ = "0.1.0"
