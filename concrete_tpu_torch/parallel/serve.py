"""A data-parallel gate front: one ServerKey's bootstrapped gates served
across the ranks of a torch.distributed group, one rank a card, each call's
batch split over them (dp, keys replicated: BASELINE config 4).

Rank 0 is the calling process, on the first card. `GateFront(key, world)`
starts `world - 1` worker ranks (the spawn start method, one a card, a
torchrun-style environment from `multihost.worker_env`), joins the group
with them, replicates the key's standard forms from rank 0 (one broadcast a
key, `multihost.replicate_from_host0`) and lets every rank derive its own
evaluation forms on its device, as `ServerKey` does. Each rank then runs
`mesh.gate_pipeline_dp` over a dp mesh of the whole group, a captured CUDA
graph on a card.

A gate call on rank 0 (spans under a torch.profiler session):
- `dp.send`: the inputs onto card 0, broadcast together and flattened
  (server_key.flat_inputs); each rank's share of the rows padded to the
  smallest warmed per-rank tier that fits (server_key.pad_size), the
  batch to `world` times that (server_key.pad_rows); a command to every
  worker (the gate's padded rows, over a pipe); the gate's linear
  combination (server_key.gate_linear) on card 0 and its broadcast to every
  rank, whole, so that the pipeline takes the same full inputs on every
  rank as its contract asks;
- every rank replays its graph on its own rows (`graph.*` spans), and rank
  0 waits for its own;
- `dp.gather`: `mesh.gather` (an all_gather) brings the rows to rank 0,
  then rank 0 waits until every worker has answered, which is the wait for
  the slowest rank;
- `dp.cut`: the padding rows cut off.
The result is bit for bit the single-card ServerKey's: rows are
independent, and the linear step and padding are ServerKey's own.
`DP_ROWS` counts every call's request and padding rows; `mesh.sent_bytes`
counts the broadcast and the gather (`planned_sent_bytes`).

Commands go over one pipe a worker, not a collective: a worker waits for
the next call for as long as the front lives, longer than any collective
may wait (the group's timeout, `TIMEOUT_S`). A worker leaves when rank 0
says stop or when its pipe closes, which is when rank 0 exits or dies. Rank
0 checks that every worker lives before a call and waits for their answers
next to their process handles, so a failed rank makes the call raise (the
front is then closed) instead of wait; `close()` stops and joins every
worker and leaves no process behind.

NCCL between cards; gloo where the caller names it (several ranks on one
card, as `multihost.placement` allows) and between CPU ranks
(device="cpu"). The gates are AND, NAND, OR, NOR, XOR, XNOR and the free
NOT; MUX is not served (`mux` raises NotImplementedError).

    front = GateFront(sks, 4)          # sks: a ServerKey; four cards
    front.warmup(batch_sizes=(2048,))  # 2048 rows a card
    out = front.and_(a, b)             # [rows, n+1] on card 0
    front.close()
"""

from __future__ import annotations

import multiprocessing.connection as mpc
import time
import traceback
import weakref

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..boolean import server_key as sk
from ..boolean.server_key import ServerKey
from ..core import checks
from ..ops import _cuda, graphs
from ..torus import from_numpy, to_numpy
from . import mesh as pmesh
from . import multihost

# rows of every front call: "request" (asked for) and "padding" (added)
DP_ROWS = graphs.Counter("dp_rows")

_GATE_SPANS = {gate: f"dp.{gate}" for gate in sk._GATE_LIN}
# seconds a collective, and rank 0's wait for a worker's answer, may take
TIMEOUT_S = 120.0


def planned_sent_bytes(cfg, padded: int, world: int) -> int:
    """The payload rank 0 hands to collectives in one call of `padded` rows
    over `world` ranks: the broadcast of the whole linear combination and
    its rows of the all_gather (a group of one rank sends nothing).

    >>> from concrete_tpu_torch.core.bootstrap import ServerConfig
    >>> from concrete_tpu_torch.params import DEFAULT_PARAMETERS
    >>> cfg = ServerConfig.from_boolean_parameters(DEFAULT_PARAMETERS)
    >>> planned_sent_bytes(cfg, 8192, 4)    # 8192 x 587 words, 2048 x 587
    24043520
    """
    if world == 1:
        return 0
    row = (cfg.lwe_dimension + 1) * 4
    return padded * row + padded // world * row


class _Rank:
    """What every rank holds: its key, the dp mesh over the whole group
    and gate_pipeline_dp on it."""

    def __init__(self, key: ServerKey, world: int):
        self.mesh = pmesh.make_mesh(world, 1, key.device.type)
        self.use(key)

    def use(self, key: ServerKey):
        self.key = key
        self.fn = pmesh.gate_pipeline_dp(key.cfg, self.mesh,
                                         key.resolved_backend())

    def fast(self, kw: dict):
        self.use(self.key.with_fast_mode(**kw))

    def receive(self, lin: torch.Tensor) -> torch.Tensor:
        """Rank 0's whole linear combination, broadcast in place."""
        pmesh._count(lin, "broadcast")
        dist.broadcast(lin, src=0)
        return lin

    def run(self, lin: torch.Tensor) -> torch.Tensor:
        """This rank's rows of lin through the pipeline."""
        return self.fn(*self.key.gate_keys(), lin)

    def gather(self, out: torch.Tensor) -> torch.Tensor:
        return pmesh.gather(out, self.mesh, self.fn.out_axes)

    def gate(self, padded: int):
        """A worker's part of one call of `padded` rows."""
        lin = torch.empty((padded, self.key.cfg.lwe_dimension + 1),
                          dtype=torch.int32, device=self.key.device)
        self.gather(self.run(self.receive(lin)))


def _replicated_key(cfg, backend: str, dev: torch.device,
                    key: ServerKey | None = None) -> ServerKey:
    """Rank 0's `key` on every rank: its standard-form BSK and KSK
    broadcast (the others pass None and receive them), each rank's
    ServerKey deriving its evaluation forms on `dev`."""
    c = cfg
    if key is None:
        bsk = torch.empty((c.lwe_dimension, c.pbs_level, c.glwe_size,
                           c.glwe_size, c.polynomial_size),
                          dtype=torch.int32, device=dev)
        ksk = torch.empty((c.big_lwe_dimension, c.ks_level,
                           c.lwe_dimension + 1), dtype=torch.int32,
                          device=dev)
    else:
        bsk = from_numpy(key.bsk_standard, dev)
        ksk = from_numpy(key.ksk, dev)
    multihost.replicate_from_host0(bsk)
    multihost.replicate_from_host0(ksk)
    if key is not None:
        return key
    return ServerKey(ksk=to_numpy(ksk), cfg=cfg, bsk_standard=to_numpy(bsk),
                     device=dev, backend=backend)


def _worker(conn, env: dict, pg_backend: str, kind: str, cfg, backend: str,
            world: int):
    """One worker rank: answers "ok" once started, joins the group,
    receives the keys, answers "ok" (or "error" and the traceback) after
    set-up and after each command of rank 0, until "stop" or until the pipe
    closes (rank 0 gone)."""
    torch.set_num_threads(1)
    conn.send(("ok",))          # started: rank 0 may join the group
    multihost.initialize_from_env(pg_backend, TIMEOUT_S, env)
    try:
        try:
            dev = multihost.rank_device(kind, int(env["LOCAL_RANK"]))
            rank = _Rank(_replicated_key(cfg, backend, dev), world)
        except Exception:
            conn.send(("error", traceback.format_exc()))
            raise
        conn.send(("ok",))
        while True:
            try:
                cmd, *args = conn.recv()
            except EOFError:
                return
            if cmd == "stop":
                return
            try:
                getattr(rank, cmd)(*args)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            except Exception:
                conn.send(("error", traceback.format_exc()))
                raise
            conn.send(("ok",))
    finally:
        dist.destroy_process_group()


def _stop(procs: list, conns: list, grace: float):
    """Tell every worker to stop, join them, kill what is left."""
    for c in conns:
        try:
            c.send(("stop",))
        except OSError:
            pass
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    for c in conns:
        c.close()


class GateFront:
    """A ServerKey's gates served over `world` ranks, one a card (the module
    docstring): `and_`, `nand`, `or_`, `nor`, `xor`, `xnor` and `not_`
    take host or device ciphertexts [..., n+1] and return the whole result
    on rank 0's device, as ServerKey's do. The key's backend must resolve
    to "ntt" or "mxu" (gate_pipeline_dp's). `backend` names the group's
    (multihost.placement: NCCL on cards, gloo on CPU ranks or where named).
    Rank 0 runs on card 0 (the key is moved there) or on the CPU; this
    process must not be in a process group already."""

    def __init__(self, key: ServerKey, world: int, *,
                 backend: str | None = None):
        kind, pg_backend = multihost.placement(key.device, backend, world)
        if dist.is_initialized():
            raise RuntimeError("this process is in a process group already; "
                               "the front makes its own")
        if kind == "cuda":
            _cuda.load_all()     # built once here, found built by the workers
        dev = multihost.rank_device(kind, 0)
        if key.device != dev:
            key = key.to(dev)
        self.world, self.device = world, dev
        self._tiers = set()
        self._closed = False
        coordinator = f"localhost:{multihost._free_port()}"
        ctx = mp.get_context("spawn")
        self._procs, self._conns = [], []
        for r in range(1, world):
            ours, theirs = ctx.Pipe()
            p = ctx.Process(target=_worker, daemon=True, args=(
                theirs, multihost.worker_env(0, 1, coordinator, world, r),
                pg_backend, kind, key.cfg, key.backend, world))
            p.start()
            theirs.close()
            self._procs.append(p)
            self._conns.append(ours)
        self.pids = [p.pid for p in self._procs]
        self._finalizer = weakref.finalize(self, _stop, self._procs,
                                           self._conns, 10.0)
        try:
            self._wait()
            multihost.initialize_from_env(
                pg_backend, TIMEOUT_S,
                multihost.worker_env(0, 1, coordinator, world, 0))
            self._rank = _Rank(_replicated_key(key.cfg, key.backend, dev, key),
                               world)
            self._wait()
        except BaseException:
            self._abort()
            raise

    # -- life cycle ----------------------------------------------------------

    def close(self):
        """Stop and join every worker, leave the process group. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._finalizer()
        dist.destroy_process_group()

    def _abort(self):
        """After a failure: kill the workers and abort the group (a
        collective may be left waiting on a rank that is gone)."""
        if self._closed:
            return
        self._closed = True
        for p in self._procs:
            p.kill()
        self._finalizer()
        if dist.is_initialized():
            dist.distributed_c10d._abort_process_group()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _check(self):
        if self._closed:
            raise RuntimeError("the gate front is closed")
        dead = {r + 1: p.exitcode for r, p in enumerate(self._procs)
                if p.exitcode is not None}
        if dead:
            self._abort()
            raise RuntimeError(f"worker ranks exited (rank: exit code): "
                               f"{dead}; the front is closed")

    def _command(self, *cmd):
        for c in self._conns:
            c.send(cmd)

    def _wait(self):
        """Every worker's answer to the last command, next to their process
        handles: raises when one reports an error, exits or gives no
        answer within TIMEOUT_S."""
        rank_of = {c: r + 1 for r, c in enumerate(self._conns)}
        rank_of.update({p.sentinel: r + 1 for r, p in enumerate(self._procs)})
        pending = set(self._conns)
        deadline = time.monotonic() + TIMEOUT_S
        while pending:
            ready = mpc.wait(list(pending) + [p.sentinel for p in self._procs],
                             max(0.0, deadline - time.monotonic()))
            if not ready:
                raise RuntimeError(
                    f"ranks {sorted(rank_of[c] for c in pending)} gave no "
                    f"answer within {TIMEOUT_S} s")
            for obj in sorted(ready, key=lambda o: o not in pending):
                if obj not in pending:
                    raise RuntimeError(f"rank {rank_of[obj]} exited during "
                                       "a call")
                try:
                    answer = obj.recv()
                except EOFError:
                    raise RuntimeError(f"rank {rank_of[obj]} exited during "
                                       "a call") from None
                if answer[0] == "error":
                    raise RuntimeError(f"rank {rank_of[obj]} failed:\n"
                                       f"{answer[1]}")
                pending.discard(obj)

    def _on_every_rank(self, cmd: str, *args):
        """A command run by the workers and by rank 0, answers awaited."""
        self._check()
        try:
            self._command(cmd, *args)
            getattr(self._rank, cmd)(*args)
            self._wait()
        except BaseException:
            self._abort()
            raise

    # -- set-up --------------------------------------------------------------

    def resolved_backend(self) -> str:
        return self._rank.key.resolved_backend()

    def warmup(self, batch_sizes=(2048,), gates=("and",), mux=False):
        """One call of each gate at `world` x each per-rank tier (each size
        rounded up to a power of two): it makes every rank's graph of the
        tier and runs the exchange once. Later calls pad each rank's share
        to the smallest warmed tier that fits. Returns {(gate, tier):
        seconds}."""
        if mux:
            raise NotImplementedError("MUX is not served by the gate front")
        unknown = [g for g in gates if g not in sk._GATE_LIN]
        if unknown:
            raise ValueError(f"gates {unknown}: expected names among "
                             f"{sorted(sk._GATE_LIN)}")
        timings = {}
        for bsz in batch_sizes:
            tier = sk.pad_size((), int(bsz))
            self._tiers.add(tier)
            z = torch.zeros((self.world * tier,
                             self._rank.key.cfg.lwe_dimension + 1),
                            dtype=torch.int32, device=self.device)
            for gate in gates:
                t0 = time.perf_counter()
                self._run_gate(gate, z, z)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                timings[(gate, tier)] = time.perf_counter() - t0
        return timings

    def with_fast_mode(self, *, limb_drop: int = 0,
                       levels: int | None = 2) -> "GateFront":
        """Every rank switches to its key's reduced-precision twin
        (ServerKey.with_fast_mode); returns this front, whose warmed tiers
        are dropped with the graphs: the ranks hold one key at a time."""
        self._on_every_rank("fast", {"limb_drop": limb_drop,
                                     "levels": levels})
        self._tiers = set()
        return self

    # -- gates ---------------------------------------------------------------

    def _run_gate(self, gate: str, a, b) -> torch.Tensor:
        self._check()
        n = self._rank.key.cfg.lwe_dimension
        with graphs.span(_GATE_SPANS[gate]):
            with graphs.span("dp.send"):
                flats, lead = sk.flat_inputs((a, b), self.device)
                checks.check_lwe(flats[0], n)
                rows = flats[0].shape[0]
                if rows == 0:
                    return torch.zeros(lead + (n + 1,), dtype=torch.int32,
                                       device=self.device)
                padded = self.world * sk.pad_size(self._tiers,
                                                  -(-rows // self.world))
                try:
                    self._command("gate", padded)
                    lin = sk.gate_linear(gate, *sk.pad_rows(flats, padded))
                    DP_ROWS.add(rows, "request")
                    DP_ROWS.add(padded - rows, "padding")
                    self._rank.receive(lin)
                except BaseException:
                    self._abort()
                    raise
            try:
                out = self._rank.run(lin)
                if self.device.type == "cuda":
                    # rank 0's own rows first, so that dp.gather holds the
                    # exchange and the wait for slower ranks, not this work
                    torch.cuda.current_stream(self.device).synchronize()
                with graphs.span("dp.gather"):
                    full = self._rank.gather(out)
                    self._wait()
            except BaseException:
                self._abort()
                raise
            with graphs.span("dp.cut"):
                return full[:rows].reshape(lead + full.shape[-1:])

    def and_(self, ct_left, ct_right):
        return self._run_gate("and", ct_left, ct_right)

    def nand(self, ct_left, ct_right):
        return self._run_gate("nand", ct_left, ct_right)

    def or_(self, ct_left, ct_right):
        return self._run_gate("or", ct_left, ct_right)

    def nor(self, ct_left, ct_right):
        return self._run_gate("nor", ct_left, ct_right)

    def xor(self, ct_left, ct_right):
        return self._run_gate("xor", ct_left, ct_right)

    def xnor(self, ct_left, ct_right):
        return self._run_gate("xnor", ct_left, ct_right)

    def not_(self, ct):
        """Free negation on rank 0, no bootstrap (ServerKey.not_)."""
        return self._rank.key.not_(ct)

    def mux(self, ct_condition, ct_then, ct_else):
        raise NotImplementedError("MUX is not served by the gate front: "
                                  "ServerKey.mux runs it on one card")
