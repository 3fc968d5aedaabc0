"""device.idle_share.dp4: the share of the profiled stretch (first traced
request's start to the last one's result) in which no device operation ran
on card 0, rank 0's card, in %."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
