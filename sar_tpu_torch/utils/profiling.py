"""Profiling and timing helpers (counterpart of sar_tpu/utils/profiling.py).

- `trace(log_dir)`: a torch.profiler window over CPU and CUDA activity that
  writes a Chrome trace (`trace.json`, for chrome://tracing or Perfetto)
  into `log_dir` when it closes, and yields the profiler;
- `force(x)`: waits until the device work behind `x` is done (a CUDA sync
  of the device of the first tensor found in `x`);
- `Timer`, `benchmark_fn`, `rtfx`: wall-clock timing whose regions are
  fenced by a CUDA sync on both sides, so a time covers the device work
  the region launched, not only its dispatch.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


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
    """torch.cuda.synchronize(device) when CUDA is there; else nothing (CPU
    work is done when its call returns)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block (CPU and, when present, CUDA activity) and write
    `log_dir`/trace.json on exit; yields the torch.profiler.profile."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=activities) as prof:
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
