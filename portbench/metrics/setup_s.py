"""setup_s: process start to ready to measure (keys, the program's key
preparation, every graph of the traffic's shapes captured, inputs made)."""


def read(ctx):
    return ctx.setup_s
