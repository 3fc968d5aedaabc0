"""One run of one cell: find the cell's configuration, traffic mix and
metrics by name, set the system up, drive the measured window, read the
trace (with --trace 1), check the answers against the plain reference,
and assemble the result line.

Everything a cell is made of is found by name under portbench/:
  configs/<config>.json     the configuration: "system" (the module of
                            systems/ that drives the program), the
                            parameters, the reduced-precision control
  traffic/<traffic>.json    the mix's parameters (traffic.py)
  cells/<workload>.json     the cell's own values, laid over the mix
  metrics/<metric>.py       one reader per metric: read(ctx) -> a number,
                            or None where it finds nothing to read
So a configuration, a mix, a cell or a metric is added with new files and
new entries in BENCHMARK.json, without an edit to a file that exists.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import traffic, tracing

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# modules that must not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "concrete_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict              # the workloads entry of BENCHMARK.json
    config: dict
    mix: dict
    pkg: Path                # the benchmark's folder, where readers lie


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json, its files read under `root`."""
    pkg = root / PKG.name
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    mix = load_json(pkg / "traffic" / f"{entry['traffic']}.json")
    own = pkg / "cells" / f"{name}.json"
    if own.exists():
        mix = {**mix, **load_json(own)}
    return Cell(name, entry, load_json(root / conf["file"]), mix, pkg)


def load_system(kind: str):
    return importlib.import_module(f"{__package__}.systems.{kind}").System


def load_reader(name: str, pkg: Path):
    """The read(ctx) function of metrics/<name>.py."""
    path = pkg / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: with --trace 0 the end-to-end
    metrics listing the cell (or listing none), with --trace 1 the
    per-layer metrics listing it, or, listing none, moving an end-to-end
    metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved
                             else [])]


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    params: dict
    system: object
    requests: list
    window_s: float
    setup_s: float
    trace: tracing.Trace | None = None


class Tracer:
    """With --trace 1: torch.profiler over the stretch [trace_skip_s,
    trace_skip_s + trace_s] of the window, started and stopped between two
    requests, each request inside a span "pb.req.<id>"; the program's
    launch counts are read at both ends."""

    def __init__(self, mix: dict, on: bool, path: Path):
        self.on, self.path = on, path
        self.skip, self.length = mix.get("trace_skip_s", 1.0), mix["trace_s"]
        self.prof = None
        self.state = "before"
        self.counts = {}

    def prime(self):
        """Pay the profiler's first start (CUPTI's set-up) before the
        window: profile one small device operation."""
        if not self.on:
            return
        import torch

        with self._profile():
            torch.ones(8, device="cuda" if torch.cuda.is_available()
                       else "cpu").sum().item()

    def _profile(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def boundary(self, clock):
        """Between two requests: start or stop the profiler by the window's
        clock (seconds since its start)."""
        if not self.on:
            return
        if self.state == "before" and clock() >= self.skip:
            self.counts = counts_snapshot()
            self.prof = self._profile()
            self.prof.start()
            self.state, self.started = "on", clock()
        elif self.state == "on" and clock() >= self.started + self.length:
            self.stop()

    def stop(self):
        if self.state != "on":
            return
        self.prof.stop()
        self.counts = counts_delta(self.counts, counts_snapshot())
        self.prof.export_chrome_trace(str(self.path))
        self.prof, self.state = None, "done"

    def span(self, rid: int):
        if self.state != "on":
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(f"{tracing.SPAN}{rid}")

    def read(self):
        if self.state == "on":
            self.stop()
        if self.state != "done":
            return None
        try:
            return tracing.read(str(self.path), self.counts)
        finally:
            self.path.unlink(missing_ok=True)


def counts_snapshot() -> dict:
    """The program's launch counts by shape key, {counter: {key: n}}."""
    from concrete_tpu_torch.ops import _cuda

    return {getattr(c, "__name__", repr(c)): dict(getattr(c, keys))
            for c, (_, keys) in _cuda.COUNTED.items()}


def counts_delta(before: dict, after: dict) -> dict:
    out = {}
    for name, keys in after.items():
        old = before.get(name, {})
        moved = {k: n - old.get(k, 0) for k, n in keys.items()}
        moved = {k: n for k, n in moved.items() if n}
        if moved:
            out[name] = moved
    return out


class Session:
    """A system set up once for a cell; windows can be driven after it
    (run.py drives one, sweep.py several at other rates)."""

    def __init__(self, cell: Cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.mix = cell.mix
        self.system = load_system(cell.config["system"])(
            cell.config, cell.mix, device, seed)

    def setup(self):
        self.timings = self.system.setup() or {}

    def prepare(self, seconds: float):
        """The window's inputs: an open loop's every request, a closed
        loop's pool of input batches."""
        if self.mix["loop"] == "open":
            self.plan = traffic.open_plan(self.mix, self.seed, seconds)
            self.system.prepare_open(self.plan)
        else:
            rows = traffic.closed_request(self.mix, self.seed, 0).rows
            self.system.prepare_closed(self.mix["pool"], rows)

    def serve(self, req, tracer: Tracer):
        req.start = time.perf_counter()
        try:
            with tracer.span(req.id):
                out = self.system.call(req)
            req.end = time.perf_counter()
            self.system.keep(req, out)
        except Exception as err:       # a failed request, counted as such
            req.end = req.end or time.perf_counter()
            req.error = repr(err)[:300]

    def window(self, seconds: float, trace: bool = False):
        """Drive the window; returns (requests, window seconds, trace)."""
        path = Path(tempfile.gettempdir()) / f"portbench-{self.cell.name}.json"
        tracer = Tracer(self.mix, trace, path)
        tracer.prime()
        requests = []
        t0 = time.perf_counter()
        clock = (lambda: time.perf_counter() - t0)
        if self.mix["loop"] == "open":
            for req in self.plan:
                due = t0 + req.due
                tracer.boundary(clock)
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                    req.late = time.perf_counter() - due
                req.due_abs = due
                self.serve(req, tracer)
                requests.append(req)
            window_s = max(seconds, requests[-1].end - t0)
        else:
            while not requests or time.perf_counter() - t0 < seconds:
                req = traffic.closed_request(self.mix, self.seed,
                                             len(requests))
                self.system.attach(req)
                tracer.boundary(clock)
                req.due_abs = time.perf_counter()
                self.serve(req, tracer)
                requests.append(req)
            window_s = requests[-1].end - t0
        return requests, window_s, tracer.read()


def memory_peak(device) -> int:
    import torch

    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def judge(checks: dict, failed: int) -> bool:
    ok = failed == 0
    for value, how, limit in checks.values():
        ok = ok and (value <= limit if how == "<=" else value >= limit)
    return ok


def run(bench: dict, cell: Cell, seed: int, seconds: float, trace: bool,
        device, t0: float, control: bool = False,
        log=lambda *a: print(*a, file=sys.stderr)) -> dict:
    """One run: the result line's object, with the checks under "checks"
    (last). t0: the host clock at process start."""
    import torch

    session = Session(cell, seed, device)
    session.setup()
    if control:
        session.system.use_control()
    t_in = time.perf_counter()
    session.prepare(seconds)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    parts = {**session.timings, "inputs_s": time.perf_counter() - t_in}
    log("set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; total from process start {setup_s:.3f} s")
    requests, window_s, tr = session.window(seconds, trace)
    peak = memory_peak(device)
    failed = [r for r in requests if r.error]
    for r in failed[:3]:
        log(f"request {r.id} ({r.op}, {r.rows} rows) failed: {r.error}")
    if cell.mix["loop"] == "open":
        late = [r.late for r in requests if r.late is not None]
        lat = sorted((r.end - r.due_abs) * 1e3 for r in requests)
        log(f"open loop: {len(requests)} requests over {window_s:.3f} s; "
            f"median latency {lat[len(lat) // 2]:.3f} ms; generator lateness "
            f"median {1e3 * float(np.median(late or [0])):.3f} ms, max "
            f"{1e3 * max(late or [0]):.3f} ms over {len(late)} idle starts")
    ctx = Context(session.system.p, session.system, requests, window_s,
                  setup_s, tr)
    metrics = {}
    for m in metrics_of(bench, cell.name, trace):
        value = load_reader(m["name"], cell.pkg)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    session.system.free_program()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = session.system.check(requests)
    log(f"reference check: {time.perf_counter() - t_ref:.3f} s")
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": int(cell.entry.get("chips", 1)),
           "memory_peak_bytes": peak}
    result = {"correct": judge(checks, len(failed)),
              "attempted": len(requests), "failed": len(failed),
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tr.busy_s if tr else 0.0
        dev["window_s"] = tr.window_s if tr else 0.0
        if tr:
            result["breakdown"] = {"device_ops": tr.device_ops,
                                   "idle_gaps": tr.idle_gaps}
    result["checks"] = {name: {"value": v, "limit": f"{how} {lim}"}
                        for name, (v, how, lim) in checks.items()}
    result["checks"]["failed_requests"] = {"value": len(failed),
                                           "limit": "<= 0"}
    return result


def forbidden_modules() -> list[str]:
    """Modules of FORBIDDEN loaded in this process, by whole top-level
    name."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def cache_env(root: Path = ROOT):
    """Every build and kernel cache of the run inside the checkout, at
    fixed paths (the program builds its kernels in its own _build/)."""
    base = root / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
