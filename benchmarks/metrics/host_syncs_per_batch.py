"""decode loop: host syncs (the segment loop's stop questions) per batch."""


def read(trace):
    n = trace.counters.get("host_syncs")
    b = trace.work.get("batches")
    return n / b if n is not None and b else None
