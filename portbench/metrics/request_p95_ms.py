"""request_p95_ms: the 95th percentile of the latency of every request due
in the window, from its due time to its result on the host (a failed
request: infinite)."""

from portbench import readers


def read(ctx):
    return readers.latency_percentile_ms(ctx, 95)
