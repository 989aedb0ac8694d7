"""cache build: device ms per batch of the decode runner's `prep` (the
int8 cross-KV cache, K2, into the runner's static cache)."""
from benchmarks.metrics._read import span_mean


def read(trace):
    return span_mean(trace, "prep")
