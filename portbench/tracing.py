"""The benchmark's reading of a torch.profiler trace: the device operations
(kernels, copies, memsets) of a profiled stretch of the window, the
benchmark's own spans around each request ("pb.req.<id>", recorded with
torch.profiler.record_function), and the host events between them.

From these: the seconds in which some device operation ran (the union of
their intervals) over the stretch and within each request's span; the
device operations that took most time; the idle gaps, each put down to the
innermost host event running at its middle on the thread that drove the
requests.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SPAN = "pb.req."
# gaps shorter than this (us) are the launch gaps inside a call
SHORT_GAP_US = 10.0


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    spans: dict          # request id -> (start us, end us, device-busy us)
    device_ops: list     # [[name, seconds]], most first
    idle_gaps: list      # [[what the host was doing, seconds]], most first
    counts: dict         # {counter name: {shape key: launches}} in the stretch


def merge(intervals: list) -> list:
    """Union of [start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Busy:
    """Device-busy time within any interval, from merged intervals."""

    def __init__(self, merged: list):
        self.starts = [s for s, _ in merged]
        self.merged = merged
        self.prefix = [0.0]
        for s, e in merged:
            self.prefix.append(self.prefix[-1] + e - s)

    def within(self, a: float, b: float) -> float:
        i = max(0, bisect.bisect_right(self.starts, a) - 1)
        j = bisect.bisect_left(self.starts, b)
        total = 0.0
        for s, e in self.merged[i:j]:
            total += max(0.0, min(e, b) - max(s, a))
        return total


def innermost(host: list, points: list) -> list:
    """For each time in `points` (sorted), the name of the innermost host
    event of `host` [(start, end, name)] running then, or None: a sweep
    with a stack of the open, nested events."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out, stack, k = [], [], 0
    for t in points:
        while k < len(host) and host[k][0] <= t:
            while stack and stack[-1][1] < host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def gap_label(name: str | None) -> str:
    if name is None:
        return "host outside any request (waiting for an arrival)"
    if name.startswith(SPAN):
        return "host in a request, outside any torch op"
    return "host in " + name[:100]


def read(path: str, counts: dict, top: int = 10) -> Trace:
    """Read a Chrome trace written by torch.profiler's export_chrome_trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, spans, span_tid = [], [], {}, None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, e.get("name", "?")))
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, e.get("name", "?"), e.get("tid")))
            if cat == "user_annotation" and e["name"].startswith(SPAN):
                spans[int(e["name"][len(SPAN):])] = (ts, ts + dur)
                span_tid = e.get("tid")
    if not spans:
        return None
    w0 = min(s for s, _ in spans.values())
    w1 = max(e for _, e in spans.values())
    merged = merge([(max(s, w0), min(e, w1)) for s, e, _ in device
                    if e > w0 and s < w1])
    busy = Busy(merged)
    by_name = collections.Counter()
    for s, e, name in device:
        if e > w0 and s < w1:
            by_name[name[:120]] += (min(e, w1) - max(s, w0)) / 1e6
    gaps, edge = [], w0
    for s, e in merged:
        if s > edge:
            gaps.append((edge, s))
        edge = e
    if w1 > edge:
        gaps.append((edge, w1))
    long_gaps = [g for g in gaps if g[1] - g[0] >= SHORT_GAP_US]
    names = innermost([(s, e, n) for s, e, n, tid in host if tid == span_tid],
                      [(a + b) / 2 for a, b in long_gaps])
    idle = collections.Counter()
    for (a, b), name in zip(long_gaps, names):
        idle[gap_label(name)] += (b - a) / 1e6
    short = sum(b - a for a, b in gaps if b - a < SHORT_GAP_US)
    if short:
        idle[f"device between launches (gaps under {SHORT_GAP_US:g} us)"] += \
            short / 1e6
    return Trace(
        window_s=(w1 - w0) / 1e6, busy_s=busy.prefix[-1] / 1e6,
        spans={i: (s, e, busy.within(s, e)) for i, (s, e) in spans.items()},
        device_ops=[[n, v] for n, v in by_name.most_common(top)],
        idle_gaps=[[n, v] for n, v in idle.most_common(top)],
        counts=counts)
