"""dp.exchange_ms.dp4: host ms a front call spends sending (the program's
span dp.send: the inputs onto card 0, the command to the ranks, the linear
combination and its broadcast) and gathering (span dp.gather: the rows back
to rank 0 and the wait for the slowest rank), the mean over the profiled
calls, from its counters span_ns and span_calls."""


def read(ctx):
    counts = ctx.trace.counts if ctx.trace else {}
    ns = counts.get("span_ns", {})
    calls = counts.get("span_calls", {}).get("dp.send")
    if not calls or "dp.send" not in ns or "dp.gather" not in ns:
        return None
    return (ns["dp.send"] + ns["dp.gather"]) / calls / 1e6
