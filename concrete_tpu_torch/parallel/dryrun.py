"""Dry runs of the sharded pipelines: the port's twins of
`__graft_entry__.dryrun_multichip` and `dryrun_multihost`.

`dryrun_multichip(n)` runs the reference's matrix over n ranks (on the
cards by default, gloo CPU processes with device="cpu"), every sharded
output bit for bit equal to the single-device call:
- u32 tp=2 with the digit split (base_log 8; dp only for odd n);
- u32 tp=4 with a nontrivial LUT (n % 4 == 0);
- u32 tp=3 with l=3 and the keyswitch replicated (6 ranks, n >= 6);
- u32 k=4 tp=5, the TPU128 shape class (n >= 5);
- the typed ShardingMismatch of each pipeline and the ntt envelope's
  refusal (n >= 6);
- u64 tp=2 on mxu and ntt, nuss u32 and u64 tp=2, u64 limb_drop=2 (n even);
- the TPU128 real keys through encrypt -> AND -> decrypt (n even, unless
  real_keys=False).
Each configuration class runs in a process group of its own size (dp x tp
ranks: tp=3 takes 6, tp=5 takes 5*(n//5)). `dryrun_multihost` is
multihost.run.

    python -m concrete_tpu_torch.parallel.dryrun 8 --device cpu
    python -m concrete_tpu_torch.parallel.dryrun 8 --backend gloo  # 1 card
    python -m concrete_tpu_torch.parallel.multihost --processes 2 \
        --ranks-per-process 4

A case is (name, configuration, pipeline, dp, tp); `case_inputs` makes its
numpy inputs from seeds, as `__graft_entry__._synthetic_server_tensors`
draws them, so another package can compute the reference from the same
arrays.

Example (the same draws as the reference's synthetic tensors):
    >>> cfg = CONFIGS["u32 bl8"]["cfg"]
    >>> bsk, ksk, lin = synthetic_tensors(cfg, 4, "raw")
    >>> bsk.shape, ksk.shape, lin.shape, int(lin[0, 0])
    ((16, 2, 2, 2, 128), (128, 3, 17), (4, 17), 2624429992)
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..core import bootstrap_mxu as bsx
from ..core import bootstrap_ntt as bsntt
from ..core import bootstrap_nuss as bsn
from ..core import checks
from ..core import lwe as lwe_ops
from ..core.bootstrap import ServerConfig
from ..ops._cuda import resolve_device
from ..torus import carrier, from_numpy, to_numpy
from . import mesh as pmesh
from . import multihost


def _cfg(n, k, poly, bl, lv, bits=32, drop=0):
    return ServerConfig(lwe_dimension=n, glwe_dimension=k,
                        polynomial_size=poly, pbs_base_log=bl, pbs_level=lv,
                        ks_base_log=4, ks_level=3, bits=bits,
                        mxu_limb_drop=drop)


# name -> the configuration, its LUT (None: the constant 1/8 of the torus;
# an int s: coefficient i holds i << s), the nuss chunking and the seed of
# its synthetic tensors (__graft_entry__.py:101-318)
CONFIGS = {
    "u32 bl8": {"cfg": _cfg(16, 1, 128, 8, 2)},
    "u32 tp4 lut": {"cfg": _cfg(12, 1, 128, 4, 4), "lut": 22},
    "u32 l3": {"cfg": _cfg(12, 1, 128, 7, 3)},
    "u32 k4": {"cfg": _cfg(10, 4, 64, 7, 2), "lut": 22},
    "u32 bad": {"cfg": _cfg(12, 1, 128, 7, 2), "l": 4},
    "u64": {"cfg": _cfg(10, 1, 64, 10, 2, bits=64), "lut": 50},
    "u64 drop2": {"cfg": _cfg(10, 1, 64, 10, 2, bits=64, drop=2), "lut": 50},
    "nuss u32": {"cfg": _cfg(8, 1, 128, 7, 2), "l": 4, "seed": 17},
    "nuss u64": {"cfg": _cfg(8, 1, 128, 7, 2, bits=64), "l": 4, "seed": 17},
    # digits of base_log 31 exceed the smallest CRT prime: no ntt backend
    "u64 bl31": {"cfg": _cfg(8, 1, 64, 31, 2, bits=64)},
}
REAL = "TPU128 real keys"


def synthetic_tensors(cfg: ServerConfig, batch: int, kind: str, seed: int = 0):
    """Key-shaped numpy arrays with valid value ranges: (bsk, ksk, lin), bsk
    the standard [n, l, k+1, k+1, N] key (kind "raw") or per-prime residues
    [n, P, l, k+1, k+1, N] (kind "ntt"), in the draws of
    __graft_entry__._synthetic_server_tensors (seed 0)."""
    rng = np.random.default_rng(seed)
    n, lv, ks1, N = (cfg.lwe_dimension, cfg.pbs_level, cfg.glwe_size,
                     cfg.polynomial_size)
    dt = np.uint32 if cfg.bits == 32 else np.uint64
    hi = 1 << cfg.bits
    if kind == "raw":
        bsk = rng.integers(0, hi, size=(n, lv, ks1, ks1, N), dtype=dt)
    elif kind == "ntt":
        bsk = np.stack([rng.integers(0, p, size=(n, lv, ks1, ks1, N),
                                     dtype=np.uint32)
                        for p in cfg.primes], axis=1).astype(dt)
    else:
        raise ValueError(f"kind {kind!r}: 'raw' or 'ntt'")
    ksk = rng.integers(0, hi, size=(cfg.big_lwe_dimension, cfg.ks_level,
                                    n + 1), dtype=dt)
    lin = rng.integers(0, hi, size=(batch, n + 1), dtype=dt)
    return bsk, ksk, lin


def lut_array(cfg: ServerConfig, shift: int | None) -> np.ndarray:
    """The accumulator [k+1, N]: the body 1/8 of the torus everywhere
    (shift None) or coefficient i = i << shift, the mask zero."""
    dt = np.uint32 if cfg.bits == 32 else np.uint64
    lut = np.zeros((cfg.glwe_size, cfg.polynomial_size), dt)
    if shift is None:
        lut[-1] = dt(1) << dt(cfg.bits - 3)
    else:
        lut[-1] = np.arange(cfg.polynomial_size, dtype=dt) << dt(shift)
    return lut


def case_inputs(config: str, pipeline: str, batch: int) -> dict:
    """The numpy inputs of a case: bsk (raw, or residues for the ntt
    pipelines), ksk [n_in, l, n_out+1], lut [k+1, N], lin [batch, n+1]."""
    spec = CONFIGS[config]
    kind = "ntt" if pipeline in ("ntt", "dp ntt") else "raw"
    bsk, ksk, lin = synthetic_tensors(spec["cfg"], batch, kind,
                                      spec.get("seed", 0))
    return {"bsk": bsk, "ksk": ksk, "lut": lut_array(spec["cfg"],
                                                     spec.get("lut")),
            "lin": lin}


def _port_inputs(config: str, pipeline: str, inp: dict, dev):
    """The port's forms of a case's inputs on `dev`: (the key its pipeline
    takes, the limb keyswitch key, lut, lin)."""
    spec = CONFIGS[config]
    cfg = spec["cfg"]
    if pipeline in ("ntt", "dp ntt"):
        bsk = torch.from_numpy(inp["bsk"].astype(np.int32)).to(dev)
    elif pipeline == "nuss":
        bsk = bsn.bsk_to_nuss(inp["bsk"], cfg, spec["l"], device=dev)
    else:
        bsk = from_numpy(bsx.bsk_to_mxu(inp["bsk"], cfg), dev)
    ksk8 = torch.from_numpy(lwe_ops.ksk_to_limbs(inp["ksk"])).to(dev)
    return (bsk, ksk8, from_numpy(inp["lut"], dev, cfg.bits),
            from_numpy(inp["lin"], dev, cfg.bits))


def pipeline_fn(pipeline: str, config: str, mesh):
    """The sharded pipeline of a case, built on `mesh`."""
    spec = CONFIGS[config]
    cfg = spec["cfg"]
    if pipeline in ("dp mxu", "dp ntt"):
        return pmesh.gate_pipeline_dp(cfg, mesh, pipeline.split()[1])
    if pipeline in ("mxu", "error mxu"):
        return pmesh.gate_pipeline_dp_tp_mxu(cfg, mesh)
    if pipeline in ("ntt", "error ntt", "envelope"):
        return pmesh.gate_pipeline_dp_tp(cfg, mesh)
    if pipeline in ("nuss", "error nuss"):
        return pmesh.gate_pipeline_dp_tp_nuss(cfg, mesh, l=spec["l"])
    raise ValueError(f"pipeline {pipeline!r}")


def single_device(pipeline: str, config: str, bsk, ksk8, lut, lin):
    """The unsharded port call a case's pipeline must equal."""
    spec = CONFIGS[config]
    cfg = spec["cfg"]
    if pipeline in ("ntt", "dp ntt"):
        return bsntt.bootstrap_keyswitch(cfg, bsk, ksk8, lut, lin)
    if pipeline == "nuss":
        return bsn.bootstrap_keyswitch_nuss(cfg, bsk, ksk8, lut, lin,
                                            l=spec["l"])
    return bsx.bootstrap_keyswitch_mxu(cfg, bsk, ksk8, lut, lin)


def _save(out_dir: Path, stem: str, t: torch.Tensor):
    np.save(out_dir / f"{stem}.npy", to_numpy(t))


def _error_case(case, mesh) -> dict:
    """Build a pipeline that must refuse its configuration: the error's type
    and message."""
    name, config, pipeline = case[:3]
    try:
        pipeline_fn(pipeline, config, mesh)
    except (checks.ShardingMismatch, NotImplementedError, ValueError) as e:
        return {"type": type(e).__name__, "message": str(e)}
    raise AssertionError(f"{name}: the pipeline took a configuration it "
                         "must refuse")


def _broadcast_case(case, dev, rows) -> torch.Tensor:
    """Rank 0's toeplitz rings, replicated: every rank's copy non-zero and
    equal to the rings made from the case's seed."""
    want = _port_inputs(case[1], "mxu", case_inputs(case[1], "mxu", rows),
                        dev)[0]
    got = want.clone() if dist.get_rank() == 0 else torch.zeros_like(want)
    multihost.replicate_from_host0(got)
    if not (got.any() and torch.equal(got, want)):
        raise AssertionError(f"{case[0]}: the broadcast key differs")
    return got


def _real_case(case, mesh, dev, rows, stats):
    """TPU128 real keys (multihost.tpu128_and_case): rank 0's server key
    replicated, encrypt -> AND -> decrypt through the tp=2 pipeline, equal
    to the single-device gate. Returns (shard, batch)."""
    cfg, inputs, ref, check, _ = multihost.tpu128_and_case(dev, rows)
    fn = pmesh.gate_pipeline_dp_tp_mxu(cfg, mesh)
    out, full = multihost.check_pipeline(case[0], fn, mesh, inputs, ref, stats)
    check(full)
    return out, full


def run_cases(out_dir: str, device: str, cases):
    """The rank target: each case on a mesh of its dp x tp (the whole
    group), its shard and the gathered batch bit for bit against the
    single-device call; saves every rank's shard ({i}.r{rank}.npy), the
    gathered batch ({i}.npy) or the refusal ({i}.json) under out_dir, and
    whether each pipeline ran graphed (graphed.json, {i: fn.graphed})."""
    out = Path(out_dir)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = multihost.rank_device(device)
    rows = 4 * world
    stats, graphed = [], {}
    for i, case in enumerate(cases):
        name, config, pipeline, dp, tp = case
        mesh = pmesh.make_mesh(dp, tp, dev.type)
        if pipeline.startswith("error") or pipeline == "envelope":
            err = _error_case(case, mesh)
            if rank == 0:
                (out / f"{i}.json").write_text(json.dumps(err))
                print(f"  {name}: {err['type']} OK: {err['message'][:60]}...",
                      flush=True)
            continue
        if pipeline == "broadcast":
            _save(out, f"{i}.r{rank}", _broadcast_case(case, dev, rows))
            continue
        if pipeline == "real":
            shard, full = _real_case(case, mesh, dev, rows, stats)
        else:
            inputs = _port_inputs(config, pipeline,
                                  case_inputs(config, pipeline, rows), dev)
            cfg = CONFIGS[config]["cfg"]
            ref = multihost.reference_from_host0(
                lambda: single_device(pipeline, config, *inputs),
                (rows, cfg.lwe_dimension + 1), carrier(cfg.bits), dev)
            fn = pipeline_fn(pipeline, config, mesh)
            shard, full = multihost.check_pipeline(name, fn, mesh, inputs,
                                                   ref, stats)
        graphed[i] = stats[-1]["graphed"]
        _save(out, f"{i}.r{rank}", shard)
        if rank == 0:
            _save(out, str(i), full)
            print(f"  {name}: dp={dp} tp={tp} batch={rows} bit-identical OK"
                  f" ({'graphed' if graphed[i] else 'eager'})", flush=True)
    if rank == 0:
        (out / "graphed.json").write_text(json.dumps(graphed))


def run_group(cases, out_dir: str, *, device=None,
              backend: str | None = None, timeout: float = 900.0):
    """Run cases of one world size (dp x tp of each) in that many ranks, on
    the cards unless device="cpu" (multihost.placement)."""
    worlds = {dp * tp for _, _, _, dp, tp in cases}
    if len(worlds) != 1:
        raise ValueError(f"one world size a group, got {sorted(worlds)}")
    world = worlds.pop()
    kind, backend = multihost.placement(device, backend, world)
    multihost.spawn(run_cases, 1, world, (out_dir, kind, list(cases)),
                    backend=backend, timeout=timeout)


def multichip_groups(n: int, real_keys: bool = True) -> list[list[tuple]]:
    """The reference's matrix over n ranks, as groups of one world size."""
    main = []
    if n % 2 == 0:
        main += [("u32 tp=2 mxu", "u32 bl8", "mxu", n // 2, 2),
                 ("u32 tp=2 ntt", "u32 bl8", "ntt", n // 2, 2)]
    else:
        main += [("u32 dp mxu", "u32 bl8", "dp mxu", n, 1),
                 ("u32 dp ntt", "u32 bl8", "dp ntt", n, 1)]
    if n % 4 == 0:
        main += [("u32 tp=4 lut mxu", "u32 tp4 lut", "mxu", n // 4, 4),
                 ("u32 tp=4 lut ntt", "u32 tp4 lut", "ntt", n // 4, 4)]
    if n % 2 == 0:
        main += [("u64 tp=2 mxu", "u64", "mxu", n // 2, 2),
                 ("u64 tp=2 ntt", "u64", "ntt", n // 2, 2),
                 ("nuss u32 tp=2", "nuss u32", "nuss", n // 2, 2),
                 ("nuss u64 tp=2", "nuss u64", "nuss", n // 2, 2),
                 ("u64 tp=2 limb_drop=2", "u64 drop2", "mxu", n // 2, 2)]
        if real_keys:
            main.append((REAL, REAL, "real", n // 2, 2))
    groups = [main]
    if n >= 6:
        groups.append([
            ("u32 tp=3 l=3 mxu", "u32 l3", "mxu", 2, 3),
            ("u32 tp=3 l=3 ntt", "u32 l3", "ntt", 2, 3),
            ("typed error mxu", "u32 bad", "error mxu", 2, 3),
            ("typed error ntt", "u32 bad", "error ntt", 2, 3),
            ("typed error nuss", "u32 bad", "error nuss", 2, 3),
            ("ntt envelope", "u64 bl31", "envelope", 2, 3)])
    if n >= 5:
        groups.append([("u32 k=4 tp=5", "u32 k4", "mxu", n // 5, 5)])
    return groups


def dryrun_multichip(n_devices: int, *, device=None,
                     backend: str | None = None, real_keys: bool = True,
                     timeout: float = 1800.0) -> None:
    """The reference's multichip matrix over n_devices ranks (module
    docstring), on the cards unless device="cpu"; raises on any
    difference."""
    device = resolve_device(device).type
    ran = []
    for group in multichip_groups(n_devices, real_keys):
        with tempfile.TemporaryDirectory() as out_dir:
            run_group(group, out_dir, device=device, backend=backend,
                      timeout=timeout)
        ran += [name for name, *_ in group]
    print(f"dryrun_multichip OK: {n_devices} ranks on {device}; matrix = "
          + ", ".join(ran) + "; all sharded outputs bit-identical to "
          "single-device", flush=True)


def dryrun_multihost(n_processes: int = 2, ranks_per_process: int = 4,
                     **kw) -> list[dict]:
    """multihost.run: key replication from rank 0, both orientations, the
    toy and TPU128 real-key tiers."""
    return multihost.run(n_processes, ranks_per_process, **kw)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("ranks", type=int, nargs="?", default=8)
    parser.add_argument("--device", default=None,
                        help="cpu, or the card (the default)")
    parser.add_argument("--backend", default=None)
    parser.add_argument("--toy-only", action="store_true")
    args = parser.parse_args(argv)
    dryrun_multichip(args.ranks, device=args.device, backend=args.backend,
                     real_keys=not args.toy_only)


if __name__ == "__main__":
    main()
