"""batching.request_row_share.latency: the rows the profiled gate calls
asked for over the rows they were padded to, from the program's counter
gate_rows (keys "request" and "padding"), in %."""


def read(ctx):
    rows = ctx.trace.counts.get("gate_rows", {}) if ctx.trace else {}
    asked = rows.get("request", 0)
    total = asked + rows.get("padding", 0)
    return 100.0 * asked / total if total else None
