"""pbs.roofline_share.latency: the least time of each call's PBS + keyswitch
on the toeplitz (mxu) u64 path (yardstick.mxu_pbs_work at the request
rows) over the device-busy time of all device operations within the call,
in %."""

from portbench import readers, yardstick


def read(ctx):
    return readers.roofline_share(
        ctx, lambda r: yardstick.mxu_pbs_work(ctx.params, r.rows))
