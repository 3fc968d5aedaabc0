"""Multi-GPU scaling: batched PBS over a torch.distributed device mesh (the
port of concrete_tpu.parallel).

- **dp** (the scaling unit): thousands of independent bootstraps sharded on
  the ciphertext batch axis, key material replicated;
- **tp**: the external product's levels or row blocks and the keyswitch
  contraction sharded over the ranks of a tp group, partial results
  combined with all_reduce.

Each pipeline replays a captured CUDA graph on the card, its NCCL
collectives inside (`mesh._compiled`), unless its tp group spans ranks on
gloo, which runs it eager.

`multihost` runs the design in several processes (torchrun-style
environment, key replication from rank 0); `dryrun` is the port's twin of
`__graft_entry__.dryrun_multichip` / `dryrun_multihost`.
"""

from .mesh import (
    make_mesh,
    gate_pipeline_dp,
    gate_pipeline_dp_tp,
    gate_pipeline_dp_tp_mxu,
    gate_pipeline_dp_tp_nuss,
)

__all__ = [
    "make_mesh",
    "gate_pipeline_dp",
    "gate_pipeline_dp_tp",
    "gate_pipeline_dp_tp_mxu",
    "gate_pipeline_dp_tp_nuss",
]
