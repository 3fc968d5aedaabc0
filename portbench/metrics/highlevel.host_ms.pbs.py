"""highlevel.host_ms.pbs: host ms per call outside device work (the
call's span less the device-busy time within it: LUT generation, encoder
copies, numpy conversions, transfers), the mean over the profiled calls."""

from portbench import readers


def read(ctx):
    ms = readers.host_ms(ctx)
    return sum(ms) / len(ms) if ms else None
