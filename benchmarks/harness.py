"""The benchmark's shared machinery: the cell's files found by name, the
import check, the device facts, the profiler's reading and the result line.

Everything that belongs to one configuration, one cell or one per-layer
metric sits in a file of its own, found by the name `BENCHMARK.json` gives:

    benchmarks/configs/<config>.json     published widths, source, reduced
    benchmarks/workloads/<cell>.json     driver, traffic, checks, why
    benchmarks/drivers/<driver>.py       run(ctx) for one kind of entry
    benchmarks/metrics/<metric>.py       read(trace) for one per-layer metric

A later PR adds a cell, a configuration or a per-layer metric by adding
such files and an entry in `BENCHMARK.json`; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
# Top-level module names that may not be loaded in a run's process: the
# JAX stack and the JAX package the port was made from. Compared whole, so
# `sar_tpu_torch` passes.
FORBIDDEN = ("jax", "jaxlib", "flax", "sar_tpu")


def forbidden_modules(names=None) -> list[str]:
    """The loaded modules whose top-level name is in FORBIDDEN."""
    names = list(sys.modules) if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of `workloads` with the files it names."""
    name: str
    chips: int
    spec: dict
    workload: dict
    config: dict
    end_to_end: list
    per_layer: list
    root: Path

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json, with its workload file
    (benchmarks/workloads/<name>.json) and its configuration's file."""
    spec = read_json(root / "BENCHMARK.json")
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no cell {name!r} in {root / 'BENCHMARK.json'}")
    entry = entries[0]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[entry["config"]]
    workload = read_json(root / "benchmarks" / "workloads" / f"{name}.json")
    config = read_json(root / cfg_entry["file"])
    if workload["config"] != entry["config"]:
        raise ValueError(f"{name}: workload file names config {workload['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    return Cell(name=name, chips=int(entry["chips"]), spec=entry, workload=workload,
                config=config,
                end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
                root=root)


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str, root: Path = ROOT):
    return _load_file(root / "benchmarks" / "drivers" / f"{name}.py",
                      f"benchmarks_driver_{name}")


def load_reader(metric: str, root: Path = ROOT):
    return _load_file(root / "benchmarks" / "metrics" / f"{metric}.py",
                      "benchmarks_metric_" + metric.replace(".", "_").replace("-", "_"))


@dataclass
class Context:
    """What a driver is given: the cell, the run's arguments and device."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    window_start: float | None = None
    fault: str | None = None      # a planted fault (the controls and tests only)

    def start_window(self) -> float:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_start = time.perf_counter()
        return self.window_start


@dataclass
class Outcome:
    """What a driver hands back once its window has closed. `metrics`: the
    end-to-end values by name; `trace`: the traced run's readings (None
    without --trace); `release` drops the program's state; `check()` then
    runs the reference and returns the compared numbers, and
    `check(control=True)` adds the float8 control's readings beside them
    (benchmarks/control.py)."""
    attempted: int
    failed: int
    metrics: dict
    release: Callable[[], None]
    check: Callable[..., list]
    trace: Trace | None = None
    notes: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# What a traced run hands the per-layer readers
# ---------------------------------------------------------------------------

@dataclass
class Trace:
    """A traced run's readings. `kernels`: (name, start_ns, end_ns) of each
    device operation in the profiled stretch, `host`: (name, start_ns,
    end_ns, is_annotation) of the host's events there, `profiled_s` its
    wall length. `spans`: name -> device milliseconds of each harness span
    (CUDA events around the harness's calls into one layer), over the
    whole window. `counters`: program counter deltas over the window.
    `work`: what the window's inputs needed (batches, steps, examples...),
    `profiled_work` the same for the profiled stretch. `config`: the
    configuration's file. `window_s`: the whole window's wall length."""
    kernels: list = field(default_factory=list)
    host: list = field(default_factory=list)
    profiled_s: float = 0.0
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)
    profiled_work: dict = field(default_factory=dict)
    config: dict = field(default_factory=dict)
    window_s: float = 0.0
    extra: dict = field(default_factory=dict)

    def kernel_seconds(self, match) -> tuple[float, int]:
        """Total device seconds and count of the kernels whose name
        `match(name)` accepts."""
        total, n = 0, 0
        for name, s, e in self.kernels:
            if match(name):
                total += e - s
                n += 1
        return total / 1e9, n


def busy_intervals(kernels) -> list[tuple[int, int]]:
    """The union of the kernels' [start, end) intervals, merged, sorted."""
    out: list[list[int]] = []
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(kernels) -> float:
    return sum(e - s for s, e in busy_intervals(kernels)) / 1e9


def read_profile(prof) -> tuple[list, list]:
    """(device operations, host events) of a finished torch.profiler run
    as (name, start_ns, end_ns[, is_annotation]) tuples, from the raw
    kineto events (the FunctionEvent tree is too slow at a few hundred
    thousand kernels). The profiler mirrors each `record_function` range
    onto the device's timeline; those are annotations, not device work,
    and are left out of the device's list."""
    kernels, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        end = s + e.duration_ns()
        note = bool(e.is_user_annotation()) or e.name().startswith("bench.")
        if str(e.device_type()).endswith("CUDA"):
            if not note:
                kernels.append((e.name(), s, end))
        else:
            host.append((e.name(), s, end, note))
    return kernels, host


def profiled(fn, device) -> tuple[list, list, float]:
    """fn() under torch.profiler, synchronised on both sides -> (device
    kernels, host events, wall seconds of the call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    kernels, host = read_profile(prof)
    return kernels, host, wall


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by what the host was doing: the innermost harness
    annotation over the gap's start, then the host operation that began
    last before it."""
    by_name: dict[str, float] = {}
    for name, s, e in trace.kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(trace.kernels)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    notes = sorted((h for h in trace.host if h[3]), key=lambda h: h[1])
    ops_h = sorted((h for h in trace.host if not h[3]), key=lambda h: h[1])
    named = []
    for s, e in gaps:
        ann = [h for h in notes if h[1] <= s < h[2]]
        inner = min(ann, key=lambda h: h[2] - h[1])[0] if ann else "outside the harness's spans"
        began = [h for h in ops_h if h[1] <= s]
        what = began[-1][0] if began else "no host operation"
        named.append([f"{inner}: {what}"[:200], (e - s) / 1e9])
    return {"device_ops": [[n[:200], v] for n, v in ops], "idle_gaps": named}


# ---------------------------------------------------------------------------
# The result line
# ---------------------------------------------------------------------------

def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def result_line(*, correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: list, breakdown: dict | None = None) -> str:
    """The last line of standard output: one JSON object. `checks` comes
    last: each compared number beside its limit."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = [{"name": c["name"], "value": c["value"], "limit": c["limit"],
                      "ok": c["ok"]} for c in checks]
    return json.dumps(out)


def checks_text(checks: list) -> str:
    return "\n".join(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}, "
                     f"{'ok' if c['ok'] else 'FAILED'})" for c in checks)
