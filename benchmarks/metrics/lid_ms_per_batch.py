"""router (LID): mean device ms per serving batch of the router's `route`
(the encoder to the classifier's tap layer, pooling and the head), from the
program's span events."""
from benchmarks.metrics._program import device_ms_per_batch


def read(trace):
    return device_ms_per_batch(trace, "route")
