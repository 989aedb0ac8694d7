"""device: the share of the profiled stretch's wall time in which no
operation ran on the card (1 - the union of the device intervals)."""
from benchmarks.metrics._read import idle


def read(trace):
    return idle(trace)
