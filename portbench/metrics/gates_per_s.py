"""gates_per_s: gate rows bootstrapped and keyswitched, results on the
host, over the whole window (first request sent to last result in)."""

from portbench import readers


def read(ctx):
    return readers.rows_per_s(ctx)
