"""% of the profiled rounds' wall time in which no operation ran on the
device (one less the union of the device operations' intervals)."""


def read(trace):
    if not trace.ops or trace.profiled_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.profiled_s)
