"""dispatch.launch_ms.latency: host ms of one graph launch (the program's span
graph.replay, around the CUDA graph launch alone), the mean over the
profiled stretch, from its counters span_ns and span_calls."""


def read(ctx):
    counts = ctx.trace.counts if ctx.trace else {}
    ns = counts.get("span_ns", {}).get("graph.replay")
    calls = counts.get("span_calls", {}).get("graph.replay")
    return ns / calls / 1e6 if ns and calls else None
