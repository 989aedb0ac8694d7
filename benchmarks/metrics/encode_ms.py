"""encoder: device ms per batch of the evaluator's `encode` (K1 and the
encoder GEMMs)."""
from benchmarks.metrics._read import span_mean


def read(trace):
    return span_mean(trace, "encode")
