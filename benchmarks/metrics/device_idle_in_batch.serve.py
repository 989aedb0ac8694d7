"""service: the share of the serving worker's batches' wall (the union of
the program's `serve.batch` spans that start in the profiled stretch, each
cut to it, as host intervals: the device waits for the batch's host work
from its start) in which no operation ran on the card."""
from benchmarks.metrics._program import idle_within, spans


def read(trace):
    return idle_within(trace, [(r.start_ns, r.end_ns) for r in spans(trace, "serve.batch")])
