"""Multi-process (multi-host-shaped) execution of the sharded gate pipeline
(the port of concrete_tpu/parallel/multihost.py).

The design scales across hosts by replicating the server keys once at set-up
(one broadcast from rank 0) and sharding the ciphertext batch (dp) across
processes, with tensor parallelism (tp) inside or across hosts. In torch one
rank is one process on one device, so a "host" here is a group of
`ranks_per_process` ranks: their ranks are consecutive, as under torchrun.
This module is that design on one machine: `run` spawns the ranks (the
spawn start method, since CUDA cannot fork), each joins the process group
from a torchrun-style environment (`worker_env`, `initialize_from_env`:
gloo between CPU processes, NCCL between cards, gloo on CUDA tensors only
when the caller names it, as for two ranks on one card) and runs
`gate_pipeline_dp_tp_mxu` over the global mesh in two orientations:
- dp across hosts (the production shape: tp inside a host);
- tp across hosts (every CMux's partial sum crosses the process boundary).

Tiers: a toy configuration with synthetic keys, then the TPU128 real keys
(n=630, k=4, N=256): rank 0 generates the server key and broadcasts its
evaluation forms, every rank derives the client key from the shared seed,
and the AND truth table is checked through the sharded pipeline. Each rank
checks its output shard bit for bit against the single-device call (made on
rank 0 and broadcast), and the all-gathered batch against the whole.

    python -m concrete_tpu_torch.parallel.multihost --processes 2 \\
        --ranks-per-process 2 --device cpu
    python -m concrete_tpu_torch.parallel.multihost --processes 2 \\
        --ranks-per-process 1 --backend gloo      # two ranks on one card

Example (the environment of rank 0 of host 1, four ranks a host):
    >>> env = worker_env(1, 2, "localhost:1234", 4)
    >>> env["RANK"], env["WORLD_SIZE"], env["LOCAL_RANK"]
    ('4', '8', '0')
    >>> env["MASTER_ADDR"], env["MASTER_PORT"], env["LOCAL_WORLD_SIZE"]
    ('localhost', '1234', '4')
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import tempfile
import time
from multiprocessing.connection import wait
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops._cuda import resolve_device
from . import mesh as pmesh


def worker_env(pid: int, n_processes: int, coordinator: str,
               ranks_per_process: int, local_rank: int = 0) -> dict:
    """The torchrun-style environment of rank `local_rank` of host `pid`
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, GROUP_RANK and the
    rendezvous address MASTER_ADDR / MASTER_PORT), from which
    `initialize_from_env` joins the process group. Pure."""
    addr, port = coordinator.rsplit(":", 1)
    return {
        "RANK": str(pid * ranks_per_process + local_rank),
        "WORLD_SIZE": str(n_processes * ranks_per_process),
        "LOCAL_RANK": str(local_rank),
        "LOCAL_WORLD_SIZE": str(ranks_per_process),
        "GROUP_RANK": str(pid),
        "MASTER_ADDR": addr,
        "MASTER_PORT": port,
    }


def initialize_from_env(backend: str | None = None,
                        timeout: float | None = None,
                        env=None) -> tuple[int, int]:
    """init_process_group at the rendezvous MASTER_ADDR:MASTER_PORT from the
    variables of `worker_env` (`env`, or this process's environment): NCCL
    where CUDA is present, gloo on a CPU-only machine, or the backend named
    (gloo on CUDA tensors only that way: there is no fallback when NCCL
    fails). Under NCCL the rank takes card LOCAL_RANK (modulo the cards
    present). `timeout`: seconds a collective may wait (torch's default
    where None). Returns (rank, world size)."""
    env = os.environ if env is None else env
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env["LOCAL_RANK"])
                              % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        rank=rank, world_size=world,
        timeout=None if timeout is None else datetime.timedelta(
            seconds=timeout))
    return rank, world


def replicate_from_host0(t: torch.Tensor) -> torch.Tensor:
    """The set-up key replication: rank 0's tensor broadcast to every rank,
    in place (the others pass a placeholder of its shape and dtype): once
    per key, not per call."""
    pmesh._count(t, "broadcast")
    dist.broadcast(t, src=0)
    return t


def reference_from_host0(call, shape, dtype, dev) -> torch.Tensor:
    """The single-device output `call()`, computed on rank 0 and broadcast
    (the others allocate its shape and dtype)."""
    ref = call() if dist.get_rank() == 0 else torch.empty(
        shape, dtype=dtype, device=dev)
    return replicate_from_host0(ref)


def placement(device=None, backend: str | None = None,
              world: int = 1) -> tuple[str, str]:
    """(device type, backend) of a group of `world` ranks: the card unless
    `device` names the CPU (ops._cuda.resolve_device: no CUDA and no device
    named raises). CPU ranks take gloo; on cards NCCL, one rank a card, so
    a world larger than the cards present raises unless `backend` names
    gloo (NCCL refuses two ranks on one GPU; there is no quiet switch)."""
    kind = resolve_device(device).type
    if kind == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r}: CPU ranks take gloo")
        return kind, "gloo"
    backend = backend or "nccl"
    cards = torch.cuda.device_count()
    if backend == "nccl" and world > cards:
        raise ValueError(
            f"{world} ranks on {cards} card(s): NCCL takes one rank a card; "
            "name backend='gloo' to share a card")
    return kind, backend


def rank_device(device: str, local_rank: int | None = None) -> torch.device:
    """This rank's device: the CPU, or card `local_rank` (LOCAL_RANK where
    None) modulo the cards present, made the current device here, on any
    backend: torch's DeviceMesh takes the raw LOCAL_RANK as the card where
    none is set yet, which does not exist where ranks share a card."""
    if device == "cuda":
        if local_rank is None:
            local_rank = int(os.environ["LOCAL_RANK"])
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        return dev
    return torch.device(device)


def make_global(mesh, spec, host_data: torch.Tensor) -> torch.Tensor:
    """This rank's shard of data that every rank holds whole (keys, a batch
    every host can regenerate): a plain tensor, the block `mesh.shard`
    cuts along `spec` (per leading dim: "dp", "tp", ("dp", "tp") or None).
    The pipelines take the whole inputs and cut their shards themselves;
    this is the same cut for a caller that keeps only its own."""
    return pmesh.shard(host_data, mesh, spec)


# ---------------------------------------------------------------------------
# spawning ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(env: dict, backend: str | None, target, args):
    os.environ.update(env)
    torch.set_num_threads(1)
    initialize_from_env(backend)
    try:
        target(*args)
    finally:
        dist.destroy_process_group()


def spawn(target, n_processes: int, ranks_per_process: int, args=(), *,
          backend: str | None = None, timeout: float = 900.0):
    """Run target(*args) in n_processes x ranks_per_process fresh processes
    (the spawn start method), each in the process group (a free localhost
    port for the rendezvous, one thread each). Raises RuntimeError when a
    rank fails or the group outlasts `timeout` seconds (all are then
    killed). `target` must live in an importable module."""
    coordinator = f"localhost:{_free_port()}"
    ctx = mp.get_context("spawn")
    procs = []
    for pid in range(n_processes):
        for local in range(ranks_per_process):
            env = worker_env(pid, n_processes, coordinator, ranks_per_process,
                             local)
            p = ctx.Process(target=_rank_main,
                            args=(env, backend, target, tuple(args)))
            p.start()
            procs.append(p)
    # wait for all, or stop at the first failure: the others would wait in
    # a collective for a rank that is gone
    deadline = time.monotonic() + timeout
    pending = procs
    while pending and time.monotonic() < deadline:
        wait([p.sentinel for p in pending], deadline - time.monotonic())
        pending = [p for p in pending if p.exitcode is None]
        if any(p.exitcode not in (None, 0) for p in procs):
            break
    failed = {r: p.exitcode for r, p in enumerate(procs)
              if p.exitcode not in (None, 0)}
    killed = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in killed:
        procs[r].kill()
        procs[r].join(10)
    if failed or killed:
        raise RuntimeError(
            f"ranks failed (rank: exit code): {failed}; killed "
            + ("after the first failure" if failed else f"after {timeout} s")
            + f": {killed}")


# ---------------------------------------------------------------------------
# the rehearsal
# ---------------------------------------------------------------------------


def planned_sent_bytes(cfg, rows: int, tp: int, world: int) -> int:
    """The payload one rank hands to collectives in one call of
    gate_pipeline_dp_tp_mxu plus the gather of its output, for `rows` dp
    rows a rank: each of the n CMux steps sums an int32 [rows, (k+1) *
    limbs * N] over tp, the keyswitch sums its partial [rows, n+1] where tp
    divides k*N, and the gather sends the output once (groups of one rank
    send nothing)."""
    from ..core.bootstrap_mxu import MxuPlan

    plan = MxuPlan.from_config(cfg)
    word = cfg.bits // 8
    out = rows * (cfg.lwe_dimension + 1) * word
    sent = out if world > 1 else 0
    if tp > 1:
        cols = plan.glwe_size * plan.limbs_used * cfg.polynomial_size
        sent += cfg.lwe_dimension * rows * cols * 4
        if cfg.big_lwe_dimension % tp == 0:
            sent += out
    return sent


def orientations(n_processes: int, ranks_per_process: int):
    """(name, rank grid) of the two meshes: dp across hosts with tp pairs
    inside a host (a host of one rank: tp = 1), and tp across hosts."""
    world = n_processes * ranks_per_process
    inner = min(2, ranks_per_process)
    return (("dp-across-hosts", torch.arange(world).reshape(-1, inner)),
            ("tp-across-hosts",
             torch.arange(world).reshape(n_processes, -1).T.contiguous()))


def _timed(fn, inputs, dev):
    """(seconds, output) of one call of fn, synchronised on the card."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn(*inputs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0, out


def check_pipeline(tag, fn, mesh, inputs, ref, stats):
    """A first call of `fn` (a graphed pipeline captures its graph there on
    the card), then one timed call on every rank: its shard equal to its
    rows of the single-device `ref`, the gathered batch equal to `ref`;
    appends to `stats` the rank's seconds (the first call and the timed
    one), the bytes the timed call and the gather hand to collectives,
    whether fn is graphed and its graphs' capture seconds by part
    (GraphedCall.captures). Returns (shard, batch)."""
    dev = ref.device
    first_s, _ = _timed(fn, inputs, dev)
    pmesh.reset_sent_bytes()
    secs, out = _timed(fn, inputs, dev)
    if not torch.equal(out, pmesh.shard(ref, mesh, (fn.out_axes,))):
        raise AssertionError(f"{tag}: rank {dist.get_rank()}'s shard differs "
                             "from the single-device call")
    full = pmesh.gather(out, mesh, fn.out_axes)
    sent = pmesh.sent_bytes()
    if not torch.equal(full, ref):
        raise AssertionError(f"{tag}: the gathered batch differs")
    stats.append({"tag": tag, "rank": dist.get_rank(), "seconds": secs,
                  "first_call_s": first_s, "sent_bytes": sent,
                  "rows": int(out.shape[0]), "graphed": fn.graphed,
                  "captures": fn.captures() if fn.graphed else []})
    return out, full


def _placeholders(cfg, dev):
    """Zero tensors of the shapes of a u32 key's toeplitz rings and limb
    keyswitch key: what the ranks but 0 hand to the broadcast."""
    from ..core.bootstrap_mxu import MxuPlan

    plan = MxuPlan.from_config(cfg)
    rings = torch.zeros((cfg.lwe_dimension, plan.row_blocks, cfg.glwe_size,
                         2 * cfg.polynomial_size), dtype=torch.int32,
                        device=dev)
    ksk8 = torch.zeros((cfg.big_lwe_dimension * cfg.ks_level,
                        4 * (cfg.lwe_dimension + 1)), dtype=torch.int8,
                       device=dev)
    return rings, ksk8


def mxu_reference(cfg, inputs, dev) -> torch.Tensor:
    """The single-device bootstrap_keyswitch_mxu of (rings, ksk8, lut, lin),
    computed on rank 0 and broadcast."""
    from ..core.bootstrap_mxu import bootstrap_keyswitch_mxu

    lin = inputs[-1]
    return reference_from_host0(
        lambda: bootstrap_keyswitch_mxu(cfg, *inputs),
        (lin.shape[0], cfg.lwe_dimension + 1), lin.dtype, dev)


def tpu128_and_case(dev, rows: int):
    """The TPU128 real-key tier (n=630, k=4, N=256) on every rank: the
    client key derives from the shared seed, the server key is generated on
    rank 0 only and its toeplitz rings and limb keyswitch key broadcast;
    every rank encrypts the same `rows` pairs (a, b) into AND's input.
    Returns (cfg, (rings, ksk8, lut, lin), ref, check, broadcast MB): ref
    the single-device gate (mxu_reference), check(out) raising unless out
    decrypts to a & b."""
    from ..boolean import ClientKey, gen_keys
    from ..boolean.client_key import PLAINTEXT_TRUE
    from ..core import bootstrap as bs
    from ..params import TPU128_PARAMETERS
    from ..torus import from_numpy

    p = TPU128_PARAMETERS
    cks = ClientKey.new(p, secret_seed=101)
    cfg = bs.ServerConfig.from_boolean_parameters(p)
    if dist.get_rank() == 0:
        _, sks = gen_keys(p, secret_seed=101, mask_seed=102, noise_seed=103,
                          device=dev)
        rings, ksk8 = sks.bsk_mxu, sks.ksk8
    else:
        rings, ksk8 = _placeholders(cfg, dev)
    mb = (rings.numel() * 4 + ksk8.numel()) / 1e6
    replicate_from_host0(rings)
    replicate_from_host0(ksk8)
    if not (rings.any() and ksk8.any()):
        raise AssertionError("the real-key broadcast produced zeros")
    rng = np.random.default_rng(11)
    av = rng.integers(0, 2, rows).astype(bool)
    bv = rng.integers(0, 2, rows).astype(bool)
    lin = (from_numpy(cks.encrypt(av, mask_seed=7, noise_seed=8), dev)
           + from_numpy(cks.encrypt(bv, mask_seed=9, noise_seed=10), dev))
    lin[:, -1] -= PLAINTEXT_TRUE                                 # AND
    inputs = (rings, ksk8, bs.trivial_lut_constant(cfg, PLAINTEXT_TRUE, dev),
              lin)

    def check(out):
        if not np.array_equal(cks.decrypt(out), av & bv):
            raise AssertionError("TPU128: AND's truth table is wrong")

    ref = mxu_reference(cfg, inputs, dev)
    check(ref)
    return cfg, inputs, ref, check, mb


def _worker(out_dir: str, n_processes: int, ranks_per_process: int,
            device: str, real_keys: bool, batch: int | None):
    """One rank of the rehearsal; writes its stats to out_dir."""
    from ..core import bootstrap as bs
    from ..core import bootstrap_mxu as bsx
    from ..core import lwe as lwe_ops
    from ..params import BooleanParameters
    from ..dispersion import StandardDev
    from ..torus import from_numpy
    from .dryrun import synthetic_tensors

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = rank_device(device)
    rows = batch or 4 * world
    stats = []

    def matrix(name, cfg, inputs, ref, check=None):
        for orient, grid in orientations(n_processes, ranks_per_process):
            mesh = pmesh.make_mesh(*grid.shape, dev.type, grid)
            fn = pmesh.gate_pipeline_dp_tp_mxu(cfg, mesh)
            tag = f"{name} {orient} dp={grid.shape[0]} tp={grid.shape[1]}"
            _, full = check_pipeline(tag, fn, mesh, inputs, ref, stats)
            if check is not None:
                check(full)
            stats[-1]["planned_bytes"] = planned_sent_bytes(
                cfg, rows // grid.shape[0], grid.shape[1], world)
            print(f"  [rank {rank}] {tag}: bit-identical OK (batch={rows})",
                  flush=True)

    # toy tier: synthetic keys of rank 0, replicated
    params = BooleanParameters(
        lwe_dimension=16, glwe_dimension=1, polynomial_size=128,
        pbs_base_log=8, pbs_level=2, ks_base_log=4, ks_level=3,
        lwe_modular_std_dev=StandardDev(2.0 ** -20),
        glwe_modular_std_dev=StandardDev(2.0 ** -25))
    cfg = bs.ServerConfig.from_boolean_parameters(params)
    if rank == 0:
        bsk_raw, ksk, _ = synthetic_tensors(cfg, 1, "raw")
        rings = from_numpy(bsx.bsk_to_mxu(bsk_raw, cfg), dev)
        ksk8 = torch.from_numpy(lwe_ops.ksk_to_limbs(ksk)).to(dev)
    else:
        rings, ksk8 = _placeholders(cfg, dev)
    replicate_from_host0(rings)
    replicate_from_host0(ksk8)
    if not (rings.any() and ksk8.any()):
        raise AssertionError("the key broadcast produced zeros")
    lut = bs.trivial_lut_constant(cfg, 1 << 29, dev)
    lin = from_numpy(np.random.default_rng(7).integers(
        0, 1 << 32, size=(rows, cfg.lwe_dimension + 1), dtype=np.uint32), dev)
    inputs = (rings, ksk8, lut, lin)
    matrix("toy", cfg, inputs, mxu_reference(cfg, inputs, dev))

    if real_keys:
        cfg_t, inputs_t, ref_t, check, mb = tpu128_and_case(dev, rows)
        matrix(f"TPU128 real keys ({mb:.1f} MB broadcast)", cfg_t, inputs_t,
               ref_t, check)

    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(stats))
    dist.barrier()
    if rank == 0:
        tiers = "toy matrix + TPU128 real keys" if real_keys else "toy matrix"
        print(f"multihost worker matrix OK ({n_processes} processes x "
              f"{ranks_per_process} ranks on {device}; {tiers})", flush=True)


def run(n_processes: int = 2, ranks_per_process: int = 4,
        timeout: float = 900.0, *, device=None, backend: str | None = None,
        real_keys: bool = True, batch: int | None = None) -> list[dict]:
    """Spawn the ranks and wait; raises on any failure. Every rank runs on
    a card (LOCAL_RANK modulo the cards present) unless `device` is "cpu";
    `placement` picks the backend (more ranks than cards need
    backend="gloo"). `batch` defaults to 4 rows a rank. Returns every
    rank's stats: per pipeline its timed call's seconds (after a first
    call, where a graphed pipeline captures), the bytes that call handed
    to collectives and the bytes the plan predicts, whether it ran
    graphed (the dp-across-hosts tier, tp=1 on a host of one rank, does;
    tp across gloo processes runs eager) and its capture seconds."""
    kind, backend = placement(device, backend,
                              n_processes * ranks_per_process)
    with tempfile.TemporaryDirectory() as out_dir:
        spawn(_worker, n_processes, ranks_per_process,
              (out_dir, n_processes, ranks_per_process, kind, real_keys,
               batch), backend=backend, timeout=timeout)
        return [s for path in sorted(Path(out_dir).glob("rank*.json"))
                for s in json.loads(path.read_text())]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--processes", type=int, default=2)
    parser.add_argument("--ranks-per-process", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="cpu, or the card (the default)")
    parser.add_argument("--backend", default=None)
    parser.add_argument("--toy-only", action="store_true")
    parser.add_argument("--batch", type=int, default=None)
    args = parser.parse_args(argv)
    for s in run(args.processes, args.ranks_per_process, device=args.device,
                 backend=args.backend, real_keys=not args.toy_only,
                 batch=args.batch):
        print(json.dumps(s))


if __name__ == "__main__":
    main()
