"""dp.collective_ms.dp4: device ms of NCCL kernels on card 0 a call (the
broadcast of the linear combination and the all_gather of the rows,
including their wait for the slowest card), the NCCL device ops of the
trace's breakdown (within the first to the last pb.req span, where a
closed loop runs nothing but its calls) over the profiled calls.

A lower bound that can drop out: the breakdown lists only the ten device
ops that took most time (tracing.read), and the two NCCL kernels, each a
few microseconds a call, rank near the tenth; one that falls below the cut
is left out, and where both do the reader gives None."""

from portbench import readers


def read(ctx):
    calls = readers.traced(ctx)
    seconds = sum(s for name, s in ctx.trace.device_ops
                  if "nccl" in name.lower()) if calls else 0.0
    return 1e3 * seconds / len(calls) if seconds else None
