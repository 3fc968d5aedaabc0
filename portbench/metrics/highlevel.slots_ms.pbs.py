"""highlevel.slots_ms.pbs: host ms a call spends in the high-level API's
per-slot Python (the program's span highlevel.slots: encoder copies and
precision updates, the keyswitch's copy and noise estimates) per batched
bootstrap (span highlevel.bootstrap), over the profiled stretch."""


def read(ctx):
    counts = ctx.trace.counts if ctx.trace else {}
    ns = counts.get("span_ns", {}).get("highlevel.slots")
    calls = counts.get("span_calls", {}).get("highlevel.bootstrap")
    return ns / calls / 1e6 if ns and calls else None
