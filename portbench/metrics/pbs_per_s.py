"""pbs_per_s: values bootstrapped through their table and keyswitched back
to the small key, results on the host, over the whole window."""

from portbench import readers


def read(ctx):
    return readers.rows_per_s(ctx)
