"""circuit.host_ms.adder8: host ms an add spends in the program's adder
outside its graph launches: the span circuit.adder (the inputs onto the
card, then issuing the 23 dependent gate calls) less the spans graph.replay
nested in it, where a launch waits while the launch queue is full of
earlier calls' work. The mean over the profiled stretch, from the counters
span_ns and span_calls; every graph launch of this cell's stretch is an
add's."""


def read(ctx):
    counts = ctx.trace.counts if ctx.trace else {}
    ns = counts.get("span_ns", {})
    calls = counts.get("span_calls", {}).get("circuit.adder")
    if not ns.get("circuit.adder") or not calls:
        return None
    return (ns["circuit.adder"] - ns.get("graph.replay", 0)) / calls / 1e6
