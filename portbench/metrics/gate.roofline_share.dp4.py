"""gate.roofline_share.dp4: the least time of card 0's part of each front
call's work on the ntt backend (yardstick.ntt_gate_work at a card's share
of the request rows, rows / dp rounded up) over card 0's device-busy time
within the call, in %. As gate.roofline_share.gates, which counts a whole
call's rows on its one card."""

from portbench import readers, yardstick


def read(ctx):
    def work(r):
        rows = -(-r.rows // int(ctx.system.config["dp"]))
        return yardstick.ntt_gate_work(ctx.params, rows,
                                       ctx.system.pbs_rows(r.op, rows),
                                       ctx.system.operands(r.op))

    return readers.roofline_share(ctx, work)
