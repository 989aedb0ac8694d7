"""service: mean host wall ms of a batch in the serving worker, from its
start to its requests' results (the program's `serve.batch` spans that
start in the profiled stretch; they end after detokenize's sync)."""
from benchmarks.metrics._program import mean, spans


def read(trace):
    return mean([(r.end_ns - r.start_ns) / 1e6 for r in spans(trace, "serve.batch")])
