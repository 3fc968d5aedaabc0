"""The one general traffic generator: a mix is a JSON file of parameters
(traffic/<name>.json, with the cell's own values from cells/<cell>.json
laid over it), and this module turns it and a seed into requests.

Keys of a mix:
  loop           "closed" (one client, the next request after the previous
                 result) or "open" (arrivals on a schedule, whatever the
                 server does)
  sizes          {"kind": "fixed", "rows": R} or {"kind": "log_uniform",
                 "low": a, "high": b}: the rows of a request
  ops            the operations requests ask for, in fixed shares: closed
                 loop in turn, open loop in an order drawn from the seed
  rate_per_s     open loop: mean arrivals a second (exponential gaps)
  schedule_seed  open loop: the seed of the arrival schedule, the order of
                 the gaps, sizes and ops, fixed in the cell: a recorded
                 Poisson arrival trace that every run replays
  pool           closed loop: distinct input batches made in set-up, used
                 in turn
  check_rows     rows of each request that the reference checks, drawn
                 from the seed
  trace_skip_s, trace_s
                 with --trace 1: the profiled stretch of the window

Every seed gets the same work: an open-loop run of S seconds has
round(rate * S) requests whose gaps are the exponential distribution's
quantiles and whose sizes are the size distribution's quantiles, in the
order the cell's schedule_seed draws, so that the tail measures the
program and not which seed bunched the arrivals; a closed-loop run sends
the same requests in the same order. --seed draws the keys, the bits or
values encrypted and which rows are checked.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Request:
    """One request and, once served, its outcome (host seconds)."""

    id: int
    op: str
    rows: int
    due: float | None = None          # open loop: seconds after the start
    inputs: object = None
    check_idx: np.ndarray | None = None
    due_abs: float | None = None      # host clock when it was due
    late: float | None = None         # open loop: start - due, server idle
    start: float | None = None
    end: float | None = None
    error: str | None = None


def quantiles(count: int) -> np.ndarray:
    """The midpoints (i + 1/2) / count of `count` equal shares of [0, 1]."""
    return (np.arange(count) + 0.5) / count


def sizes(spec: dict, q: np.ndarray) -> np.ndarray:
    """Request rows at quantiles q of the size distribution."""
    if spec["kind"] == "fixed":
        return np.full(q.shape, int(spec["rows"]), dtype=np.int64)
    if spec["kind"] == "log_uniform":
        lo, hi = math.log(spec["low"]), math.log(spec["high"] + 1)
        return np.minimum(np.floor(np.exp(lo + q * (hi - lo))),
                          spec["high"]).astype(np.int64)
    raise ValueError(f"unknown size distribution {spec['kind']!r}")


def check_rows(rng: np.random.Generator, rows: int, count: int):
    return np.sort(rng.choice(rows, size=min(rows, count), replace=False))


def open_plan(mix: dict, seed: int, seconds: float) -> list[Request]:
    """Every request of an open-loop window, due times from 0: the gaps
    (the exponential distribution's quantiles at the rate), sizes and ops
    in an order drawn from the mix's schedule_seed, the same for every
    --seed; the rows checked drawn from --seed."""
    count = max(1, round(mix["rate_per_s"] * seconds))
    order = np.random.default_rng([int(mix["schedule_seed"]), 1])
    q = quantiles(count)
    gaps = order.permutation(-np.log1p(-q) / mix["rate_per_s"])
    rows = order.permutation(sizes(mix["sizes"], q))
    ops = order.permutation(np.array([mix["ops"][i % len(mix["ops"])]
                                      for i in range(count)], dtype=object))
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    rng = np.random.default_rng([seed, 1])
    return [Request(i, str(ops[i]), int(rows[i]), float(due[i]),
                    check_idx=check_rows(rng, int(rows[i]),
                                         mix["check_rows"]))
            for i in range(count)]


def closed_request(mix: dict, seed: int, i: int) -> Request:
    """The i-th request of a closed loop: the ops in turn, input batch
    i mod pool."""
    rows = int(sizes(mix["sizes"], np.array([0.5]))[0])
    rng = np.random.default_rng([seed, 2, i])
    return Request(i, mix["ops"][i % len(mix["ops"])], rows,
                   check_idx=check_rows(rng, rows, mix["check_rows"]))
