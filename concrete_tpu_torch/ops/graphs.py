"""One captured CUDA graph per input signature: the port's counterpart of
``jax.jit``.

concrete_tpu compiles each gate, and each PBS + keyswitch, into one XLA
program per shape and replays it (``_gate_pipeline``, ``_mux_pipeline``,
``jit_bootstrap_keyswitch*``), so that a call reaches the TPU as one
dispatch. On a CUDA card the counterpart of that program is a CUDA graph:
``GraphedCall(fn, n_static)`` wraps ``fn(*static, *inputs)``, where the
`static` arguments are key tensors that the graph reads where they lie
(their identity is part of the signature) and the `inputs` are copied into
the graph's own buffers on every call.

On CUDA tensors, the first call with a new signature (input shapes and
dtypes, the device, the static tensors' identity) runs `fn` once on a side
stream, which builds what is built at first use (cuBLASLt's workspace, the
per-device tables of math/ntt.py and core/bootstrap_ntt.py), then captures
it with ``torch.cuda.graph`` into the call's memory pool (``GraphPool``,
which several calls may share). Every call then copies its inputs in,
replays the graph and returns a clone of its output, all on the caller's
current stream: the next replay of any graph of the pool starts after the
clone, so graphs that share a pool replay in any order. On CPU tensors
`fn` is called. There is no fallback: a capture that fails raises
``GraphCaptureError`` with the line that broke it, and a call never runs
eagerly on the card instead.

The kernel wrappers count their launches in Python (``_cuda.count_launch``),
and other modules keep plain counts there too (``Counter``: the bytes
parallel/mesh.py hands to collectives); under replay that Python runs
only while the graph is captured. So a graph keeps what its capture added
to every registered count (``count_record``), the capture's own counts are
taken back out, and every replay adds the record (``add_counts``): the
counts are those of the work the card did.

``span(name)`` names a stretch of host work for torch.profiler: while a
profiler session runs, it is a ``record_function`` in the trace (on the
profiler's clock, nested in whatever span is open) and adds its
nanoseconds and one call to ``SPAN_NS`` and ``SPAN_CALLS`` under its name;
with no session, and inside a capture, it does nothing. Spans sit at layer
boundaries on the host, never in a captured function or a kernel wrapper;
here: ``graph.copy_in``, ``graph.replay`` (the graph launch alone) and
``graph.clone_out`` in every replay, ``graph.capture`` around a capture.
``CAPTURE_NS`` keeps each capture's seconds (warm run, capture,
instantiation), by the call's name, as nanoseconds.

Example (on the CPU the wrapped function runs as it is):
    >>> import torch
    >>> double = GraphedCall(lambda key, x: key * x, 1)
    >>> double(torch.tensor([2]), torch.tensor([1, 2, 3])).tolist()
    [2, 4, 6]
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import time
import traceback
import weakref

import torch

from . import _cuda


class GraphCaptureError(RuntimeError):
    """A call could not be captured into a CUDA graph."""


# ---------------------------------------------------------------------------
# count accounting
# ---------------------------------------------------------------------------


class Counter:
    """A plain count kept in Python, accounted for under replay as the
    kernel wrappers' launches are: `total` and `by_key`, {key: count}.
    Registered in _cuda.COUNTED for the life of the process.

    >>> sent = Counter("sent_bytes")
    >>> sent.add(8, "all_reduce"); sent.add(4, "all_reduce")
    >>> sent.total, sent.by_key
    (12, {'all_reduce': 12})
    """

    def __init__(self, name: str):
        self.__name__ = name
        self.total = 0
        self.by_key = {}
        _cuda.COUNTED[self] = ("total", "by_key")

    def add(self, n: int, key: str):
        self.total += n
        self.by_key[key] = self.by_key.get(key, 0) + n

    def reset(self):
        self.total, self.by_key = 0, {}


def snapshot() -> dict:
    """Every registered count's (total, {key: count}): each kernel
    wrapper's launches by shape key, each Counter's."""
    return {c: (getattr(c, total), dict(getattr(c, by_key)))
            for c, (total, by_key) in _cuda.COUNTED.items()}


def count_record(before: dict, after: dict) -> dict:
    """The counts between two snapshots, {count: (total, {key: n})}; counts
    that did not move are left out.

    >>> def k(): pass
    >>> k = _cuda.counter(k)
    >>> before = snapshot()
    >>> _cuda.count_launch(k, B=4); _cuda.count_launch(k, B=8)
    >>> count_record(before, snapshot())[k]
    (2, {'B=4': 1, 'B=8': 1})
    """
    record = {}
    for c, (n, keys) in after.items():
        n0, keys0 = before.get(c, (0, {}))
        if n != n0:
            record[c] = (n - n0, {key: v - keys0.get(key, 0)
                                  for key, v in keys.items()
                                  if v != keys0.get(key, 0)})
    return record


def add_counts(record: dict, times: int = 1):
    """Add `times` x `record` to the counts; times=-1 takes a record back
    out (a key left at 0 goes, as if never counted)."""
    for c, (n, keys) in record.items():
        total, by_key = _cuda.COUNTED[c]
        setattr(c, total, getattr(c, total) + times * n)
        into = getattr(c, by_key)
        for key, v in keys.items():
            left = into.get(key, 0) + times * v
            if left:
                into[key] = left
            else:
                into.pop(key, None)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

SPAN_NS = Counter("span_ns")
SPAN_CALLS = Counter("span_calls")
CAPTURE_NS = Counter("capture_ns")

_OFF = contextlib.nullcontext()
# set by _capture around its graph capture: a span there would put its
# nanoseconds into the capture's count record, which every replay adds
_capturing = False


class _Span:
    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        self._rf.__exit__(*exc)
        SPAN_NS.add(ns, self.name)
        SPAN_CALLS.add(1, self.name)


def span(name: str):
    """A context manager naming a stretch of host work (see the module
    docstring): recorded only while a torch.profiler session runs, and
    never inside a capture; else one shared no-op.

    >>> with span("example"):
    ...     pass
    >>> "example" in SPAN_CALLS.by_key
    False
    """
    if _capturing or not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


# ---------------------------------------------------------------------------
# capture and replay
# ---------------------------------------------------------------------------

_TORCH_DIR = os.path.dirname(torch.__file__)

# one capture stream per device for the whole process, as torch.cuda.graph
# keeps one: captures into a shared pool should use the same stream
_CAPTURE_STREAMS: dict = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    if device.index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device.index] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device.index]


def _origin(exc: BaseException) -> tuple[str, BaseException]:
    """(where, error): the first error of `exc`'s chain (a failed capture
    raises again when the capture is closed) and the innermost line outside
    torch and this module that it came from."""
    chain = []
    while exc is not None and exc not in chain:
        chain.append(exc)
        exc = exc.__context__
    first = chain[-1]
    frames = [f for f in traceback.extract_tb(first.__traceback__)
              if not f.filename.startswith(_TORCH_DIR)
              and f.filename != __file__]
    if not frames:
        return "an unknown line", first
    f = frames[-1]
    return f"{f.filename}:{f.lineno} in {f.name} ({f.line})", first


class GraphPool:
    """A CUDA graph memory pool (``torch.cuda.graph_pool_handle()``), made at
    the first capture into it; the graphs of one key share one. `graphs`
    counts the graphs captured into it that are kept: once the last is
    dropped the allocator has released the pool, which then refuses a
    capture, so the next capture makes a new one."""

    def __init__(self):
        self._handle = None
        self.graphs = 0

    @property
    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def kept(self):
        self.graphs += 1

    def dropped(self):
        self.graphs -= 1
        if not self.graphs:
            self._handle = None


def _drop_graph(graphs: dict, pool: GraphPool, key):
    """Drop graph `key` of a call (one of its static tensors was freed)."""
    if graphs.pop(key, None) is not None:
        pool.dropped()


@dataclasses.dataclass
class CapturedGraph:
    """One signature's graph: its input buffers and output, what one replay
    adds to the counts (count_record), and what the capture cost."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    output: torch.Tensor
    counts: dict
    warm_s: float          # the first run of fn, on a side stream
    capture_s: float       # fn recorded into the graph
    instantiate_s: float   # capture end: the executable graph made

    def replay(self, inputs) -> torch.Tensor:
        with span("graph.copy_in"):
            for buf, x in zip(self.inputs, inputs):
                buf.copy_(x)
        with span("graph.replay"):
            self.graph.replay()
        add_counts(self.counts)
        with span("graph.clone_out"):
            return self.output.clone()


def _capture(fn, static, inputs, pool: GraphPool, name: str) -> CapturedGraph:
    global _capturing
    device = inputs[0].device if inputs else static[0].device
    current = torch.cuda.current_stream(device)
    bufs = tuple(x.clone() for x in inputs)   # outside the pool, kept
    t0 = time.perf_counter()
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fn(*static, *bufs)
    current.wait_stream(side)
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    stream = _capture_stream(device)
    before = snapshot()
    _capturing = True
    # no cyclic collection inside the capture: a dead cycle's CUDA graph
    # destroyed there invalidates it (torch.cuda.graph collects no more
    # before capturing). This covers graphs held by cycles only: fn must
    # not drop the last plain reference to a graph itself
    collecting = gc.isenabled()
    gc.disable()
    try:
        # the outer context restores the caller's stream even when the
        # capture's end raises (the graph context then leaves its own open)
        with torch.cuda.device(device), torch.cuda.stream(stream):
            with torch.cuda.graph(graph, pool=pool.handle, stream=stream):
                out = fn(*static, *bufs)
                t2 = time.perf_counter()
    except RuntimeError as exc:   # a CUDA call that a capture refuses
        where, first = _origin(exc)
        raise GraphCaptureError(
            f"{name}: CUDA graph capture failed at {where}: "
            f"{type(first).__name__}: {first}") from exc
    finally:
        _capturing = False
        if collecting:
            gc.enable()
        record = count_record(before, snapshot())
        add_counts(record, -1)
    t3 = time.perf_counter()
    if not isinstance(out, torch.Tensor):
        raise GraphCaptureError(f"{name}: returns {type(out).__name__}, "
                                "expected one tensor")
    CAPTURE_NS.add(round((t3 - t0) * 1e9), name)
    return CapturedGraph(graph, bufs, out, record, t1 - t0, t2 - t1, t3 - t2)


def _device(args) -> torch.device:
    if not all(isinstance(a, torch.Tensor) for a in args):
        raise TypeError("a graphed call takes tensors only")
    devices = {a.device for a in args}
    if len(devices) != 1:
        raise ValueError(f"tensors must share one device, got {devices}")
    return devices.pop()


class GraphedCall:
    """``fn(*static, *inputs)`` replayed from one CUDA graph per signature
    on CUDA tensors, called as it is on CPU tensors (see the module
    docstring). The first `n_static` arguments are the static ones. A
    graph is dropped when one of its static tensors is freed. `pool` is
    shared with other calls (a key's), else the call makes its own."""

    def __init__(self, fn, n_static: int = 0, *, name: str | None = None,
                 pool: GraphPool | None = None):
        self.fn = fn
        self.n_static = n_static
        self.name = name or getattr(fn, "__name__", repr(fn))
        self.pool = GraphPool() if pool is None else pool
        self.graphs: dict = {}

    def __call__(self, *args) -> torch.Tensor:
        device = _device(args)
        if device.type != "cuda":
            return self.fn(*args)
        static, inputs = args[:self.n_static], args[self.n_static:]
        key = (device, tuple(id(t) for t in static),
               tuple((tuple(x.shape), x.dtype) for x in inputs))
        graph = self.graphs.get(key)
        if graph is None:
            with span("graph.capture"):
                graph = _capture(self.fn, static, inputs, self.pool,
                                 self.name)
            self.graphs[key] = graph
            self.pool.kept()
            for t in static:    # the ids stay the tensors' own while kept
                weakref.finalize(t, _drop_graph, self.graphs, self.pool, key)
        if device.index != torch.cuda.current_device():
            with torch.cuda.device(device):
                return graph.replay(inputs)
        return graph.replay(inputs)

    def captures(self) -> list[dict]:
        """Per graph: the input shapes, the capture's seconds by part, the
        kernel launches one replay counts and what it adds to each
        Counter."""
        return [{"inputs": [list(s) for s, _ in key[2]],
                 "warm_s": g.warm_s, "capture_s": g.capture_s,
                 "instantiate_s": g.instantiate_s,
                 "launches_per_replay": sum(
                     n for c, (n, _) in g.counts.items()
                     if not isinstance(c, Counter)),
                 **{c.__name__ + "_per_replay": n
                    for c, (n, _) in g.counts.items()
                    if isinstance(c, Counter)}}
                for key, g in self.graphs.items()]
