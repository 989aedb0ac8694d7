"""Profiling and timing helpers (counterpart of sar_tpu/utils/profiling.py).

- `span(name)`, `interval(...)`, `spans()`, `active()`: the program's own
  spans (below);
- `trace(log_dir)`: a torch.profiler window over CPU and CUDA activity on
  every thread that writes a Chrome trace (`trace.json`, for
  chrome://tracing or Perfetto) into `log_dir` when it closes, and yields
  the profiler;
- `force(x)`: waits until the device work behind `x` is done (a CUDA sync
  of the device of the first tensor found in `x`);
- `Timer`, `benchmark_fn`, `rtfx`: wall-clock timing whose regions are
  fenced by a CUDA sync on both sides, so a time covers the device work
  the region launched, not only its dispatch.

Spans. The port marks its layers where the work happens: the serving
worker's batch and its stages, LID, the encoder, the cache build, the
decode loop and each of its segments and host syncs, detokenization. A
span is recorded only while a torch profiler is active in the process
(`active()`); otherwise `span()` is one flag read that returns a shared
no-op context manager. A recorded span keeps its name, its start and end
in `time.time_ns()` (the clock of the profiler's host events), its id, its
parent (the enclosing span on the same thread) and a trace id (given, or
the parent's: every span of one serving batch carries the batch's id). It
also opens `record_function("sar.<name>")`, so it appears in the profile
of any thread the profiler covers, and, once CUDA is in use, records a
timing event on the current stream at each edge, except while that stream
is capturing a CUDA graph. Device milliseconds are resolved when the
record is read (`spans()`), never on the hot path. Records go to a
bounded in-memory deque; nothing is written to disk.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def sync(device=None) -> None:
    """torch.cuda.synchronize(device) when CUDA is there and `device` is
    None or a CUDA device; else nothing (CPU work is done when its call
    returns)."""
    if torch.cuda.is_available() and (device is None
                                      or torch.device(device).type == "cuda"):
        torch.cuda.synchronize(device)


# -- spans ---------------------------------------------------------------------

MAX_SPANS = 16384           # records kept; the oldest are dropped first


@dataclass
class SpanRecord:
    """One span: `start_ns`/`end_ns` on time.time_ns()'s clock; `parent`
    the enclosing span's id (or the one given to `interval`);
    `device_ms` the device time between its edges' events, None where it
    recorded none (no CUDA, a capturing stream, an interval)."""
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent: int | None
    trace_id: object
    device_ms: float | None = None
    _events: tuple | None = field(default=None, repr=False)


class _Local(threading.local):
    def __init__(self):
        self.stack: list[SpanRecord] = []       # this thread's open spans


_RECORDS: collections.deque = collections.deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_LOCAL = _Local()


def active() -> bool:
    """Whether a torch profiler is active in the process (on any thread)."""
    return _autograd_profiler._is_profiler_enabled


def _event():
    """A timing event recorded now on the current stream, or None where
    CUDA is not in use or the stream is capturing."""
    if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("rec", "start", "range")

    def __init__(self, name: str, trace_id):
        self.rec = SpanRecord(name, 0, 0, next(_IDS), None, trace_id)

    def __enter__(self) -> SpanRecord:
        rec, stack = self.rec, _LOCAL.stack
        if stack:
            rec.parent = stack[-1].span_id
            if rec.trace_id is None:
                rec.trace_id = stack[-1].trace_id
        stack.append(rec)
        rec.start_ns = time.time_ns()
        self.range = torch.profiler.record_function(f"sar.{rec.name}")
        self.range.__enter__()
        self.start = _event()
        return rec

    def __exit__(self, *exc):
        end = _event() if self.start is not None else None
        self.range.__exit__(*exc)
        rec = self.rec
        rec.end_ns = time.time_ns()
        _LOCAL.stack.pop()
        if end is not None:
            rec._events = (self.start, end)
        _RECORDS.append(rec)
        return False


def span(name: str, *, trace_id=None):
    """A context manager that records the span `name` while a profiler is
    active (see the module docstring) and yields its SpanRecord; with no
    profiler it records nothing and yields None."""
    if not active():
        return _NO_SPAN
    return _Span(name, trace_id)


def interval(name: str, start_ns: int, end_ns: int, *, trace_id=None,
             parent: int | None = None) -> None:
    """Record a span whose edges were read elsewhere (its start on another
    thread, say), host times only, while a profiler is active."""
    if active():
        _RECORDS.append(SpanRecord(name, start_ns, end_ns, next(_IDS), parent,
                                   trace_id))


def spans(name: str | None = None) -> list[SpanRecord]:
    """The recorded spans (of `name`, when given), oldest first, each with
    its device milliseconds resolved (waiting for its end event)."""
    out = [r for r in list(_RECORDS) if name is None or r.name == name]
    for r in out:
        if r._events is not None:
            start, end = r._events
            end.synchronize()
            r.device_ms = start.elapsed_time(end)
            r._events = None
    return out


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block (CPU and, when present, CUDA activity, on every
    thread: a service's worker too) and write `log_dir`/trace.json on
    exit; yields the torch.profiler.profile."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
        sync()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def force(x):
    """Wait for the computation behind `x` (a tensor or a nest of them):
    a sync of the CUDA device of its first CUDA tensor. Returns x."""
    for t in _tensors(x):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            break
    return x


class Timer:
    """`with Timer() as t: ...` -> t.elapsed seconds, the block fenced by a
    CUDA sync at entry and at exit."""

    def __enter__(self):
        sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync()
        self.elapsed = time.perf_counter() - self.t0


def benchmark_fn(fn, *args, iters: int = 3, warmup: int = 1) -> dict:
    """Time fn(*args) after `warmup` calls -> {"total_s", "per_iter_s",
    "iters", "iter_s"}: the fenced wall of all iterations and of each."""
    for _ in range(warmup):
        force(fn(*args))
    walls = []
    with Timer() as t:
        for _ in range(iters):
            with Timer() as one:
                fn(*args)
            walls.append(one.elapsed)
    return {"total_s": t.elapsed, "per_iter_s": t.elapsed / iters,
            "iters": iters, "iter_s": walls}


def rtfx(fn, *args, audio_seconds: float, iters: int = 3) -> float:
    """Real-time factor: audio seconds processed per wall-clock second."""
    return audio_seconds / benchmark_fn(fn, *args, iters=iters)["per_iter_s"]
