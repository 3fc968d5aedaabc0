"""dispatch.host_ms.latency: per request, its service time (dequeue to
result on the host) less the device-busy time within it; the median over
the profiled requests, ms."""

import statistics

from portbench import readers


def read(ctx):
    ms = readers.host_ms(ctx)
    return statistics.median(ms) if ms else None
