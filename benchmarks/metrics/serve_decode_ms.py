"""decode loop: mean device ms per serving batch of the worker's `decode`
(the routed captured greedy loop), from the program's span events."""
from benchmarks.metrics._program import device_ms_per_batch


def read(trace):
    return device_ms_per_batch(trace, "decode")
