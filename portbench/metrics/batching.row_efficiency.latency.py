"""batching.row_efficiency.latency: the rows the profiled requests needed
blind-rotated (two a MUX row) over the rows the blind rotations computed,
read from the program's launch counts by shape key, in %."""

from portbench import readers


def read(ctx):
    computed = readers.rotated_rows(ctx)
    if not computed:
        return None
    needed = sum(ctx.system.pbs_rows(r.op, r.rows)
                 for r, _, _ in readers.traced(ctx))
    return 100.0 * needed / computed
