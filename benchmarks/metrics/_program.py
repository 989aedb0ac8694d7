"""Helpers of the readers of the program's own spans and counters
(sar_tpu_torch/utils/profiling.py, decode/graphs.py::CAPTURE).

The program records a span only while a profiler is active, on
time.time_ns()'s clock, which is the clock of the profiler's host events;
its device milliseconds come from CUDA events at the span's edges. The
readers take the spans of the traced stretch: the `bench.profiled` range
when the run has one (serve), else the extent of the profiled host events
(the eval cells' profiled batch). A program without these spans or
counters (an older tree) gives None, as does a stretch with nothing to
read; a share is never reported as 0 for want of a reading.
"""

from __future__ import annotations

from benchmarks import harness


def stretch(trace):
    """(start_ns, end_ns) of the traced stretch, or None."""
    marked = [(h[1], h[2]) for h in trace.host if h[0] == "bench.profiled"]
    if marked:
        return marked[0]
    if not trace.host:
        return None
    return min(h[1] for h in trace.host), max(h[2] for h in trace.host)


def spans(trace, name: str, edge: str = "start") -> list:
    """The program's spans `name` whose `edge` ("start" or "end") lies in
    the traced stretch; [] when the program records none."""
    from sar_tpu_torch.utils import profiling
    read = getattr(profiling, "spans", None)
    window = stretch(trace)
    if read is None or window is None:
        return []
    lo, hi = window
    return [r for r in read(name) if lo <= getattr(r, f"{edge}_ns") <= hi]


def mean(xs):
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else None


def device_ms_per_batch(trace, name: str):
    """Mean over the serving batches that start in the stretch of the
    device ms of their spans `name` (a batch's spans carry its trace id)."""
    batches = {r.trace_id for r in spans(trace, "serve.batch")}
    per: dict = {}
    for r in spans(trace, name):
        if r.trace_id in batches and r.device_ms is not None:
            per[r.trace_id] = per.get(r.trace_id, 0.0) + r.device_ms
    return mean(per.values())


def on_device(r) -> tuple[int, int]:
    """A span's interval on the device's timeline: its device milliseconds
    ending at its host end. That holds where the span ends right after the
    host waited for the device (a decode loop ends with its last host sync
    and a copy of the tokens), while its host start can lie far ahead of
    the device, which may still run the work launched before (the
    encoder's)."""
    return r.end_ns - round(r.device_ms * 1e6), r.end_ns


def idle_within(trace, intervals):
    """100 x (1 - the device's busy time inside the union of `intervals`
    ((start_ns, end_ns) pairs), each cut to the traced stretch / the
    union's length); None without device operations or intervals."""
    window = stretch(trace)
    if not trace.kernels or window is None:
        return None
    lo, hi = window
    cut = [(max(s, lo), min(e, hi)) for s, e in intervals if s < hi and e > lo]
    if not cut:
        return None
    union = harness.busy_intervals([(None, s, e) for s, e in cut])
    wall = sum(e - s for s, e in union)
    if wall <= 0:
        return None
    busy = 0
    for bs, be in harness.busy_intervals(trace.kernels):
        for s, e in union:
            busy += max(0, min(be, e) - max(bs, s))
    return 100.0 * (1.0 - busy / wall)


def capture():
    """graphs.CAPTURE, or None where the program has none or captured
    nothing."""
    from sar_tpu_torch.decode import graphs
    counts = getattr(graphs, "CAPTURE", None)
    return counts if counts and counts["graphs"] else None
