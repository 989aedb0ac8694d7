"""service: the median latency of the same requests as the p95, each from
its due time to its result (a missing one counted as slower than any)."""
import numpy as np

from benchmarks.traffic import arrivals


def read(trace):
    lat = trace.extra.get("latencies_ms")
    if lat is None or not len(lat):
        return None
    return arrivals.percentile(np.asarray(lat), 50)
