"""Sharded gate-bootstrap pipelines over a torch.distributed device mesh
(the port of concrete_tpu/parallel/mesh.py).

dp shards the ciphertext batch: no collective, keys replicated. dp + tp
also splits each CMux's work over the ranks of a tp group: every rank holds
a slice of the bootstrap key (levels, row blocks) and of the keyswitch
key's input dimension, and the partial results meet in an `all_reduce`
over the tp group:
- the toeplitz ("mxu") and Nussbaumer ("nuss") partial dots are int32 sums
  that the plan's row bound keeps inside int32 for the full contraction, so
  the wrapping sum is exact;
- the NTT partials are residues mod p: carried as unsigned values in int64,
  summed, then reduced mod p (`_psum_mod_p`);
- the keyswitch partials wrap mod 2^bits in the torus carrier (int32 /
  int64), like the sums inside one rank.

Each factory returns what concrete_tpu's `jax.jit(shard_map(...))` is to
the card: a GraphedCall (ops/graphs.py) that captures the pipeline once per
signature and replays one CUDA graph per call, the keys (bsk, ksk8) read
in place and narrowed to the rank's slice inside the graph, lut and lin
copied in; NCCL collectives are captured with the rest, and `gather`'s
`all_gather` runs outside the graph on the same communicator. Where the
body makes a collective over a tp group of more than one rank on another
backend (gloo: its collectives synchronise through the host, which no
capture holds), the factory returns the pipeline eager. Which of the two
is decided from the mesh when the pipeline is built and read in
`fn.graphed`; on CPU tensors either runs the pipeline as it is.

Every rank calls a pipeline with the same full inputs (the keys in the
port's forms, `bsk_to_mxu` / `bsk_to_ntt` / `bsk_to_nuss` and
`lwe.ksk_to_limbs`, and the whole batch). It takes its own dp rows and its
own tp slice (`shard`) and returns its dp shard of the output, the same on
every rank of its tp group; `gather` assembles the whole batch. Each output
is bit for bit the single-device call's.

The mesh covers the process group: one rank per device (on one card,
several ranks need the gloo backend, since NCCL refuses two ranks on one
GPU). Where tp does not divide the axis it shards, the factories raise
core.checks.ShardingMismatch, as concrete_tpu does.

Example (one process, a world of one):
    >>> import tempfile, os, torch.distributed as dist
    >>> store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    >>> dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    >>> mesh = make_mesh(1, 1, "cpu")
    >>> mesh.mesh_dim_names, tuple(mesh.shape)
    (('dp', 'tp'), (1, 1))
    >>> from ..core.bootstrap import ServerConfig
    >>> cfg = ServerConfig(lwe_dimension=4, glwe_dimension=1,
    ...                    polynomial_size=64, pbs_base_log=8, pbs_level=2,
    ...                    ks_base_log=4, ks_level=3)
    >>> fn = gate_pipeline_dp_tp_mxu(cfg, mesh)
    >>> fn.graphed, fn.out_axes
    (True, ('dp',))
    >>> dist.destroy_process_group()
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core import bootstrap_mxu as bsx
from ..core import bootstrap_ntt as bsntt
from ..core import bootstrap_nuss as bsn
from ..core import checks
from ..core.backends import BACKENDS
from ..core import lwe as lwe_ops
from ..core.bootstrap import ServerConfig, rotation_start, sample_extract
from ..math import ntt, polynomial
from ..ops import graphs
from ..torus import carrier

# bytes this process has handed to collectives over groups of more than one
# rank since the last reset_sent_bytes(), by collective (the payload, not
# the transport's traffic); a replayed pipeline adds what its capture
# counted, so the count is what the card sent
SENT = graphs.Counter("sent_bytes")


def sent_bytes() -> int:
    return SENT.total


def reset_sent_bytes():
    SENT.reset()


def _count(t: torch.Tensor, collective: str, group=None):
    if dist.get_world_size(group) > 1:
        SENT.add(t.numel() * t.element_size(), collective)


def make_mesh(dp: int, tp: int = 1, device_type: str = "cuda",
              ranks=None) -> DeviceMesh:
    """A dp x tp DeviceMesh with mesh_dim_names ("dp", "tp") over the whole
    initialised process group: ranks 0 .. dp*tp-1 row-major, or the grid
    `ranks` (e.g. tp across hosts: arange(world).reshape(hosts, -1).T). The
    tests pass device_type="cpu"."""
    world = dist.get_world_size()
    if dp * tp != world:
        raise ValueError(f"dp x tp = {dp} x {tp} must cover the {world} "
                         "ranks of the process group")
    grid = torch.arange(world) if ranks is None else torch.as_tensor(ranks)
    return DeviceMesh(device_type, grid.reshape(dp, tp),
                      mesh_dim_names=("dp", "tp"))


def _coord(mesh: DeviceMesh, axis) -> tuple[int, int]:
    """(extent, this rank's index) of a mesh axis, or of ("dp", "tp")
    flattened dp-major."""
    if isinstance(axis, tuple):
        size, idx = 1, 0
        for a in axis:
            n, i = _coord(mesh, a)
            size, idx = size * n, idx * n + i
        return size, idx
    return mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)


def shard(t: torch.Tensor, mesh: DeviceMesh, spec) -> torch.Tensor:
    """This rank's block of `t`: spec names, per leading dim, the mesh axis
    it is split over ("dp", "tp", ("dp", "tp")) or None (replicated). A
    view: contiguous where only the leading split dim is cut."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        size, idx = _coord(mesh, axis)
        extent = t.shape[dim]
        if extent % size:
            raise checks.ShardingMismatch(
                f"{axis}={size} does not divide axis {dim} of extent {extent}")
        step = extent // size
        t = t.narrow(dim, idx * step, step)
    return t


def gather(out: torch.Tensor, mesh: DeviceMesh, axes=("dp",)) -> torch.Tensor:
    """The whole batch from every rank's shard (`fn.out_axes` of a
    pipeline): one all_gather over the process group, then the shards of
    this rank's group along `axes`, in mesh order."""
    out = out.contiguous()
    parts = [torch.empty_like(out) for _ in range(dist.get_world_size())]
    _count(out, "all_gather")
    dist.all_gather(parts, out)
    grid = mesh.mesh
    if axes == ("dp",):
        ranks = grid[:, mesh.get_local_rank("tp")]
    elif tuple(axes) == ("dp", "tp"):
        ranks = grid.flatten()
    else:
        raise ValueError(f"axes {axes}: ('dp',) or ('dp', 'tp')")
    return torch.cat([parts[int(r)] for r in ranks])


def _tp(mesh: DeviceMesh):
    size, idx = _coord(mesh, "tp")
    return size, idx, mesh.get_group("tp")


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    _count(t, "all_reduce", group)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _compiled(run, mesh: DeviceMesh, name: str, collective: bool):
    """`run` (fn(bsk, ksk8, lut, lin), its `out_axes` set) as the factory
    returns it: a GraphedCall with the two keys static, or, where the body
    makes a collective (`collective`) over a tp group of more than one rank
    whose backend is not NCCL, `run` itself, eager. Either carries
    `out_axes` and `graphed`. One graph pool per pipeline."""
    size, _, group = _tp(mesh)
    if collective and size > 1 and dist.get_backend(group) != "nccl":
        run.graphed = False
        return run
    call = graphs.GraphedCall(run, 2, name=name)
    call.out_axes, call.graphed = run.out_axes, True
    return call


def _sum_over(mesh: DeviceMesh):
    """The `reduce` hook of the single-device CMux loops
    (bootstrap_mxu.step_dot): the in-place int32 sum of a partial dot over
    this rank's tp group, or None where the group has one rank (nothing to
    sum)."""
    size, _, group = _tp(mesh)
    return None if size == 1 else lambda s: _all_reduce(s, group)


# ---------------------------------------------------------------------------
# dp-only: batch sharding, keys replicated
# ---------------------------------------------------------------------------


def gate_pipeline_dp(cfg: ServerConfig, mesh: DeviceMesh, backend: str = "ntt"):
    """PBS + keyswitch with the batch on the dp x tp ranks, keys replicated
    (the production scaling mode, BASELINE config 4: 16k PBS across a mesh).
    backend "mxu" runs bootstrap_mxu.bootstrap_keyswitch_mxu (K2, K1, int8
    product, at large batch K3), "ntt" bootstrap_ntt.bootstrap_keyswitch
    (K9 on the u32 torus with two primes). fn(bsk, ksk8, lut, lin) returns
    this rank's rows (fn.out_axes = ("dp", "tp")); it makes no collective,
    so it is graphed on any mesh."""
    if backend not in ("mxu", "ntt"):
        raise ValueError(f"backend {backend!r}: 'mxu' or 'ntt'")
    BACKENDS[backend].check(cfg)
    bks = BACKENDS[backend].bootstrap_keyswitch

    def run(bsk, ksk8, lut, lin):
        return bks(cfg, bsk, ksk8, lut, shard(lin, mesh, (("dp", "tp"),)))

    run.out_axes = ("dp", "tp")
    return _compiled(run, mesh, f"gate_pipeline_dp ({backend})",
                     collective=False)


# ---------------------------------------------------------------------------
# dp + tp: the keyswitch contraction on tp
# ---------------------------------------------------------------------------


def _keyswitch_tp(cfg: ServerConfig, ksk8: torch.Tensor, big: torch.Tensor,
                  mesh: DeviceMesh) -> torch.Tensor:
    """Keyswitch [B, k*N+1] against the full limb key ksk8
    [n_in*l, n_limbs*(n_out+1)], the input-key contraction split over tp
    where tp divides n_in = k*N (a power of two): each rank switches its
    n_in/tp mask coefficients (one contiguous block of (n_in/tp)*l key
    rows) with a zero body, the partials add with a wrapping all_reduce,
    and the body is added once. Elsewhere (odd tp, or a tp group of one
    rank) the key is replicated and each rank switches its rows alone, as
    concrete_tpu does (parallel/mesh.py:158-161): the keyswitch is a small
    share of a gate (0.6 of 95.9 ms of the TPU128 ntt AND at B=2048 on an
    H100, PERF.md §5)."""
    size, idx, group = _tp(mesh)
    kw = dict(base_log=cfg.ks_base_log, level_count=cfg.ks_level)
    if size == 1 or cfg.big_lwe_dimension % size:
        return lwe_ops.keyswitch_prepared(ksk8, big, **kw)
    mask = shard(big[:, :-1], mesh, (None, "tp"))
    part = lwe_ops.keyswitch_prepared(
        shard(ksk8, mesh, ("tp",)),
        torch.cat([mask, torch.zeros_like(big[:, -1:])], dim=1), **kw)
    _all_reduce(part, group)
    part[:, -1] += big[:, -1]
    return part


def _checked_inputs(cfg: ServerConfig, mesh: DeviceMesh, lut, lin):
    """This rank's dp rows of lin, after the single-device calls' checks."""
    checks.check_glwe(lut, cfg.glwe_size, cfg.polynomial_size, "accumulator")
    checks.check_lwe(lin, cfg.lwe_dimension)
    if lin.dtype != carrier(cfg.bits) or lut.dtype != lin.dtype:
        raise TypeError(f"u{cfg.bits} torus tensors are {carrier(cfg.bits)}")
    return shard(lin.reshape(-1, lin.shape[-1]), mesh, ("dp",))


# ---------------------------------------------------------------------------
# dp + tp on the ntt path: decomposition levels on tp, mod-p sums
# ---------------------------------------------------------------------------


def _psum_mod_p(x: torch.Tensor, sp: ntt.StackedNttPlans, group):
    """Exact mod-p sum over the tp group of residues [P, ...]: their bit
    patterns as unsigned values in int64 (a sum of int32 carriers would
    overflow), all_reduce, then % p."""
    wide = x.to(torch.int64) & 0xFFFFFFFF
    _all_reduce(wide, group)
    return wide % sp._bc(sp.p, wide)


def gate_pipeline_dp_tp(cfg: ServerConfig, mesh: DeviceMesh):
    """The ntt pipeline with the batch on dp and, on tp, the decomposition
    levels of every CMux's external product (bsk_to_ntt [n, P, l, k+1, k+1,
    N] split on l) and the keyswitch contraction. Each rank transforms and
    MACs its levels (bootstrap_ntt._external_product_stacked on its slice);
    the Montgomery partials meet mod p (_psum_mod_p; no collective in a tp
    group of one rank) before the inverse transform and the CRT. This is the torch composition on both tori, as
    the JAX pipeline runs XLA outside any Pallas kernel: K9 computes a whole
    CMux step over every level, so it does not split over levels.

    Raises what concrete_tpu raises at construction for a configuration
    outside the ntt envelope (ServerConfig.primes), and ShardingMismatch
    unless tp divides pbs_level. fn.out_axes = ("dp",); graphed unless the
    tp group has more than one rank on a backend other than NCCL."""
    sp = ntt.make_stacked_plans(cfg.polynomial_size, cfg.primes)
    tp, idx, group = _tp(mesh)
    checks.check_tp_divides(
        "pbs_level (the NTT pipeline shards decomposition levels)",
        cfg.pbs_level, tp,
        hint="the mxu pipeline shards l*(k+1) row blocks and admits more "
             "tp degrees")
    lv = cfg.pbs_level // tp
    reduce = None if tp == 1 else (lambda acc: _psum_mod_p(acc, sp, group))

    def run(bsk_ntt, ksk8, lut, lin):
        checks.check_bsk_ntt(bsk_ntt, cfg)
        rows = _checked_inputs(cfg, mesh, lut, lin)
        mine = shard(bsk_ntt, mesh, (None, None, "tp"))
        acc, a_hats = rotation_start(lut, rows, cfg.polynomial_size)
        for i in range(cfg.lwe_dimension):
            rot = polynomial.negacyclic_monomial_mul(acc, a_hats[i][None, :])
            acc = acc + bsntt._external_product_stacked(
                cfg, sp, mine[i], rot - acc, idx * lv, reduce)
        big = sample_extract(acc.transpose(0, 1))
        return _keyswitch_tp(cfg, ksk8, big, mesh)

    run.out_axes = ("dp",)
    return _compiled(run, mesh, "gate_pipeline_dp_tp", collective=True)


# ---------------------------------------------------------------------------
# dp + tp on the mxu path: digit row blocks on tp, wrapping int32 sums
# ---------------------------------------------------------------------------


def gate_pipeline_dp_tp_mxu(cfg: ServerConfig, mesh: DeviceMesh):
    """The mxu pipeline with the batch on dp and, on tp, the row blocks R of
    the toeplitz rings (bsk_to_mxu [n, R, (k+1)*n_words, 2N]; R = the gadget
    levels x sub-digits x k+1) and the keyswitch contraction. Each rank
    builds its local table with K1 from its ring blocks and multiplies it by
    its columns of the digit matrix (K2 on u32, K4 on u64: the bits of
    concrete_tpu's _digit_matrix, of which the JAX pipeline slices the same
    columns); the int32 partial dots add exactly (the plan's row bound
    covers the full contraction), then recombine_acc. The loop is
    the single-device one (bootstrap_mxu.scan_for, with the rank's window
    and the sum as hooks): at batches where auto_defer holds (u32; B >=
    8192 at TPU128) the recombine is folded into the next step's K3. A
    rank that holds part of the R blocks keeps the table (auto_window);
    a tp group of one takes the single-device loop's window step at small
    u64 batches. Both tori, mxu_limb_drop included. ShardingMismatch
    unless tp divides R. fn.out_axes = ("dp",); graphed as
    gate_pipeline_dp_tp is."""
    plan = bsx.MxuPlan.from_config(cfg)
    tp, idx, _ = _tp(mesh)
    checks.check_tp_divides(
        f"row_blocks = pbs_level*(k+1)*n_sub = {plan.level}*"
        f"{plan.glwe_size}*{plan.n_sub}", plan.row_blocks, tp)
    block0, reduce = idx * plan.row_blocks // tp, _sum_over(mesh)

    def run(rings, ksk8, lut, lin):
        checks.check_bsk_mxu(rings, cfg)
        rows = _checked_inputs(cfg, mesh, lut, lin)
        acc, a_hats = rotation_start(lut, rows, cfg.polynomial_size)
        scan = bsx.scan_for(plan, acc.shape[1], blocks=plan.row_blocks // tp)
        acc = scan(plan, shard(rings, mesh, (None, "tp")), acc, a_hats,
                   block0, reduce)
        return _keyswitch_tp(cfg, ksk8, sample_extract(acc.transpose(0, 1)),
                             mesh)

    run.out_axes = ("dp",)
    return _compiled(run, mesh, "gate_pipeline_dp_tp_mxu", collective=True)


# ---------------------------------------------------------------------------
# dp + tp on the Nussbaumer path (large N): per-frequency row blocks on tp
# ---------------------------------------------------------------------------


def gate_pipeline_dp_tp_nuss(cfg: ServerConfig, mesh: DeviceMesh,
                             l: int | None = None):
    """The Nussbaumer pipeline (the N > 4096 class) with the batch on dp
    and, on tp, the per-frequency row blocks R' (the rings bsk_to_nuss
    [n, 2L*R', (k+1)*n_words, 2M] viewed as [n, 2L, R', ., 2M]) and the
    keyswitch contraction. Each CMux: K7 gives the full digit spectra, the
    rank builds its tables for every frequency with K1 from its R'/tp
    blocks and multiplies its columns, one int32 all_reduce sums the 2L
    partial products (exact, as on mxu), and the inverse transform and
    recombine (K5 / K6) run replicated in the tp group: the single-device
    loop (bootstrap_nuss.rotate_nuss) with the rank's blocks and the sum as
    hooks. Both tori. ShardingMismatch unless tp divides R'. fn.out_axes =
    ("dp",); graphed as gate_pipeline_dp_tp is."""
    plan = bsn.NussPlan.from_config(cfg, l)
    tp, idx, _ = _tp(mesh)
    checks.check_tp_divides(
        f"nuss row_blocks R' = pbs_level*(k+1)*n_sub = {plan.level}*"
        f"{plan.glwe_size}*{plan.n_sub}", plan.row_blocks, tp)
    two_l, blocks = plan.two_l, plan.row_blocks // tp
    reduce = _sum_over(mesh)

    def run(rings, ksk8, lut, lin):
        n_lwe = cfg.lwe_dimension
        ring = tuple(rings.shape[2:])
        if tuple(rings.shape) != (n_lwe, two_l * plan.row_blocks,
                                  plan.glwe_size * plan.n_words, 2 * plan.m):
            raise checks.KeyParameterMismatch(
                f"nuss rings: shape {tuple(rings.shape)} does not match the "
                "configuration")
        rows = _checked_inputs(cfg, mesh, lut, lin)
        mine = shard(rings.reshape((n_lwe, two_l, plan.row_blocks) + ring),
                     mesh, (None, None, "tp"))
        acc, a_hats = rotation_start(lut, rows, cfg.polynomial_size)
        acc = bsn.rotate_nuss(plan,
                              mine.reshape((n_lwe, two_l * blocks) + ring),
                              acc, a_hats, idx * blocks, reduce)
        return _keyswitch_tp(cfg, ksk8, sample_extract(acc.transpose(0, 1)),
                             mesh)

    run.out_axes = ("dp",)
    return _compiled(run, mesh, "gate_pipeline_dp_tp_nuss", collective=True)
