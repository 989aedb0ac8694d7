"""Helpers the per-layer readers share. Each reader returns None when the
run gives it nothing to read (the metric is then left out of the line),
never 0 for a share of a roofline or a peak."""

from __future__ import annotations

from benchmarks import harness
from benchmarks.counts import whisper as counts


def span_mean(trace, name: str):
    ms = (trace.spans or {}).get(name)
    return sum(ms) / len(ms) if ms else None


def roofline(trace, kernel_names: tuple[str, ...], bound_s: float):
    """100 x the least time the profiled stretch's calls could take over
    the device time of the kernels whose name holds one of
    `kernel_names`."""
    t, n = trace.kernel_seconds(lambda k: any(s in k for s in kernel_names))
    if not n or t <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / t


def idle(trace):
    if not trace.kernels or trace.profiled_s <= 0:
        return None
    return 100.0 * (1.0 - harness.busy_seconds(trace.kernels) / trace.profiled_s)


def mfu(trace):
    flops = trace.work.get("flops")
    if not flops or trace.window_s <= 0:
        return None
    return 100.0 * flops / (trace.window_s * counts.BF16)
