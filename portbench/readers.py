"""Arithmetic the metric readers (metrics/<name>.py) share, on a
harness.Context: rates over the window, latency percentiles, and from a
trace the device-busy time of each profiled request, roofline shares,
host time outside device work and the rows the blind rotation computed.
"""

from __future__ import annotations

import math
import re


def rows_per_s(ctx) -> float:
    """Rows of the requests answered, over the whole window."""
    return sum(r.rows for r in ctx.requests if not r.error) / ctx.window_s


def latency_percentile_ms(ctx, pct: float) -> float | None:
    """The pct-th percentile (nearest rank) of every request's latency,
    due time to result on the host; a failed request counts as infinitely
    late (None where that is the percentile)."""
    lat = sorted(math.inf if r.error else (r.end - r.due_abs) * 1e3
                 for r in ctx.requests)
    value = lat[max(0, math.ceil(pct / 100 * len(lat)) - 1)]
    return None if math.isinf(value) else value


def traced(ctx) -> list:
    """(request, span us, device-busy us) of every request answered in the
    profiled stretch."""
    if ctx.trace is None:
        return []
    by_id = {r.id: r for r in ctx.requests}
    return [(by_id[i], e - s, busy) for i, (s, e, busy)
            in sorted(ctx.trace.spans.items())
            if i in by_id and not by_id[i].error]


def roofline_share(ctx, work) -> float | None:
    """The least time of the traced requests' work (work(request): a
    yardstick.Work) over their device-busy time, in %."""
    rows = traced(ctx)
    busy = sum(b for _, _, b in rows)
    if not rows or busy <= 0:
        return None
    return 100.0 * sum(work(r).bound_seconds() for r, _, _ in rows) / (
        busy / 1e6)


def host_ms(ctx) -> list[float]:
    """Per traced request: its span less the device-busy time within it."""
    return [(span - busy) / 1e3 for _, span, busy in traced(ctx)]


def idle_share(ctx) -> float | None:
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def rotated_rows(ctx) -> float | None:
    """Rows the blind rotations computed in the profiled stretch, from the
    program's launch counts: a step kernel's launches times their batch B
    (its shape key), over the steps of a rotation (lwe_dimension); the
    kernel with the most."""
    steps = ctx.params["lwe_dimension"]
    best = 0.0
    for keys in (ctx.trace.counts if ctx.trace else {}).values():
        total = 0
        for key, n in keys.items():
            m = re.search(r"(?:^| )B=(\d+)", key)
            if m:
                total += n * int(m.group(1))
        best = max(best, total / steps)
    return best or None
