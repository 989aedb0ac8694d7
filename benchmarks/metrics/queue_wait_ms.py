"""service: mean ms a request waited in the queue, from its submit to the
start of its batch (the program's `serve.queue_wait` intervals that end in
the profiled stretch)."""
from benchmarks.metrics._program import mean, spans


def read(trace):
    return mean([(r.end_ns - r.start_ns) / 1e6 for r in spans(trace, "serve.queue_wait", "end")])
