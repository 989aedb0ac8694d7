"""decode loop: device ms of the runner's greedy loop over the decode
steps it ran (the segments counter's delta)."""


def read(trace):
    ms = (trace.spans or {}).get("decode")
    steps = trace.counters.get("steps")
    return sum(ms) / steps if ms and steps else None
