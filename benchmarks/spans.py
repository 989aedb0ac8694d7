"""Spans that the harness records around its own calls into the program's
layers, in a traced run: a CUDA event on each side (device time, read once
the window has closed) and a `record_function` range named `bench.<layer>`
that the profiler's host timeline shows. On the CPU (the harness's tests)
an event is the host clock.
"""

from __future__ import annotations

import time

import torch


class _HostEvent:
    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Spans:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.pending: list[tuple[str, object, object]] = []
        self.patched: list[tuple[object, str, object]] = []

    def mark(self):
        """An event recorded now on the current stream."""
        if not self.cuda:
            return _HostEvent()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def add(self, name: str, start, end) -> None:
        self.pending.append((name, start, end))

    def wrap(self, owner, attr: str, name: str, start=None) -> None:
        """Replace owner.attr by a wrapper that records the span `name`
        around each call; `start()`, when given, supplies the span's start
        event instead of the call's own (a span that begins earlier, such
        as the frontend's, which starts with the batch)."""
        fn = getattr(owner, attr)
        spans = self

        def wrapped(*args, **kwargs):
            s = start() if start is not None else spans.mark()
            with torch.profiler.record_function(f"bench.{name}"):
                out = fn(*args, **kwargs)
            spans.add(name, s, spans.mark())
            return out

        self.patched.append((owner, attr, vars(owner).get(attr)))
        setattr(owner, attr, wrapped)

    def restore(self) -> None:
        for owner, attr, old in reversed(self.patched):
            if old is None:
                delattr(owner, attr)      # an instance attribute hid the method
            else:
                setattr(owner, attr, old)
        self.patched.clear()

    def result(self) -> dict[str, list[float]]:
        """name -> milliseconds of each span (synchronises first)."""
        if self.cuda:
            torch.cuda.synchronize()
        out: dict[str, list[float]] = {}
        for name, s, e in self.pending:
            out.setdefault(name, []).append(s.elapsed_time(e))
        return out
