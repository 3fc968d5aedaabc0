"""setup.capture_s: seconds the program spent making its CUDA graphs since
the process started (its counter capture_ns, by graphed call: each
capture's warm run, capture and instantiation), nearly all in set-up. Read
from the program's registered counts, not the profiled stretch's."""

from portbench import harness


def read(ctx):
    keys = harness.counts_snapshot().get("capture_ns")
    return sum(keys.values()) / 1e9 if keys else None
