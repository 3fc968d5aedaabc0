"""gate.roofline_share.gates: the least time of each gate call's work on
the ntt backend (yardstick.ntt_gate_work at the request rows) over the
device-busy time of all device operations within the call, in %."""

from portbench import readers, yardstick


def read(ctx):
    return readers.roofline_share(ctx, lambda r: yardstick.ntt_gate_work(
        ctx.params, r.rows, ctx.system.pbs_rows(r.op, r.rows),
        ctx.system.operands(r.op)))
