"""device.idle_share.pbs: the share of the profiled stretch (first
traced request's start to the last one's result) in which no device
operation ran, in %."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
