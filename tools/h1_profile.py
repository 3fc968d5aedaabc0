#!/usr/bin/env python3
"""Profile one eager call of each sharded pipeline at chip_smoke.py's H1
shapes, on one GPU: the device-busy time a replayed graph of the same
work can approach.

    python3 tools/h1_profile.py

On a one-rank NCCL group (make_mesh(1, 1)) at B=2048, with the keys of
chip_smoke.py's phase H1 (TPU128 and DEFAULT on mxu and ntt, the TPU128
ntt twin through the level-split composition, the TFHE_LIB nuss twin), it
calls each pipeline's eager body (`fn.fn`) once to warm it, then once
under profiling.profile_call: one JSON line per pipeline with the wall ms,
the device ms by kernel kind, the device operations seen and the idle
share. No graph is captured and nothing is compared: chip_smoke.py holds
the replays to the eager calls.
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from concrete_tpu_torch import boolean, torus  # noqa: E402
from concrete_tpu_torch.boolean.client_key import (  # noqa: E402
    PLAINTEXT_LOG_SCALING_FACTOR,
)
from concrete_tpu_torch.ops import _cuda  # noqa: E402
from concrete_tpu_torch.params import (  # noqa: E402
    DEFAULT_PARAMETERS,
    TFHE_LIB_PARAMETERS,
    TPU128_PARAMETERS,
)
from concrete_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from concrete_tpu_torch.profiling import profile_call  # noqa: E402

BATCH = 2048


def cells(name, sks, mesh):
    cfg = sks.cfg
    if name == "TFHE_LIB":
        return [("gate_pipeline_dp_tp_nuss",
                 pmesh.gate_pipeline_dp_tp_nuss(cfg, mesh), sks.bsk_nuss)]
    out = [("gate_pipeline_dp mxu", pmesh.gate_pipeline_dp(cfg, mesh, "mxu"),
            sks.bsk_mxu),
           ("gate_pipeline_dp ntt", pmesh.gate_pipeline_dp(cfg, mesh, "ntt"),
            sks.bsk_ntt),
           ("gate_pipeline_dp_tp_mxu", pmesh.gate_pipeline_dp_tp_mxu(cfg, mesh),
            sks.bsk_mxu)]
    if name == "TPU128":
        out.append(("gate_pipeline_dp_tp (ntt, level split)",
                    pmesh.gate_pipeline_dp_tp(cfg, mesh), sks.bsk_ntt))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("h1_profile: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _cuda.load_all()
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh(1, 1, "cuda")
        for name, params in (("TPU128", TPU128_PARAMETERS),
                             ("DEFAULT", DEFAULT_PARAMETERS),
                             ("TFHE_LIB", TFHE_LIB_PARAMETERS)):
            cks, sks = boolean.gen_keys(params, secret_seed=11, mask_seed=12,
                                        noise_seed=13, device=dev)
            ca = cks.encrypt(np.arange(BATCH) % 2 == 0, mask_seed=1,
                             noise_seed=2)
            lin = torus.from_numpy(ca, dev) * 2
            lin[:, -1] -= 1 << (32 - PLAINTEXT_LOG_SCALING_FACTOR)
            for pipeline, fn, bsk in cells(name, sks, mesh):
                args = (bsk, *sks.gate_keys()[1:], lin)
                fn.fn(*args)
                stats = profile_call(lambda: fn.fn(*args))
                print(json.dumps({"params": name, "pipeline": pipeline,
                                  "batch": BATCH, "eager": True, **stats,
                                  "card": card}), flush=True)
            del sks
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
