"""encoder front (conv2d subsampling): device ms per batch of the
program's `encode.subsample` span (OWSM's two 3x3 stride-2 convolutions,
the Linear and the positions) in the profiled batch; None where the
program records no such span."""
from benchmarks.metrics._program import mean, spans


def read(trace):
    return mean([r.device_ms for r in spans(trace, "encode.subsample")])
