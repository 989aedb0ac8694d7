"""One run of one benchmark cell of sar_tpu_torch.

    python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Loads the cell's files by name (harness.py),
makes the weights and the traffic from the seed, builds the program and
warms up the cell's own shapes (all of that is `setup_s`), measures for
`--seconds`, then checks the answers against the plain reference and
prints one JSON object as the last line of standard output (with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics read from a profiled stretch). Exits non-zero with no result when
CUDA is absent or has fewer cards than the cell asks for, and when a JAX
module or the JAX package was loaded in the process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmarks import harness  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The port builds its kernels into build/sar_tpu_torch/<source hash>/
    beside its package; these cover any other compiler a library may call."""
    base = root / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def fail(msg: str, code: int = 1) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return code


def main(argv=None, root: Path | None = None, device=None) -> int:
    """Run one cell. `root` is the checkout (default: this one); `device`
    skips the look for a card (the harness's own tests pass "cpu")."""
    args = parse_args(argv)
    root = Path(root) if root is not None else harness.ROOT
    cache_dirs(root)
    cell = harness.load_cell(args.workload, root)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return fail("no CUDA device: the benchmark measures the card only")
        if torch.cuda.device_count() < cell.chips:
            return fail(f"{cell.name} needs {cell.chips} cards, "
                        f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    driver = harness.load_driver(cell.workload["driver"], root)
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device=device)
    t_driver = time.perf_counter()
    out: harness.Outcome = driver.run(ctx)
    out.notes["imports and files"] = round(t_driver - T_START, 3)
    bad = harness.forbidden_modules()
    if bad:
        return fail("modules of JAX or of the JAX package were loaded: " + ", ".join(bad), 3)
    cuda = device.type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    out.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = out.check()
    out.notes["check_s"] = round(time.perf_counter() - t_check, 3)
    bad = harness.forbidden_modules()
    if bad:
        return fail("modules of JAX or of the JAX package were loaded: " + ", ".join(bad), 3)
    units = {m["name"]: m["unit"] for m in cell.metrics(ctx.trace)}
    metrics = {}
    if ctx.trace:
        for m in cell.per_layer:
            value = harness.load_reader(m["name"], root).read(out.trace)
            if value is not None and harness.finite(value):
                metrics[m["name"]] = {"value": float(value), "unit": units[m["name"]]}
    else:
        values = dict(out.metrics, setup_s=ctx.window_start - T_START)
        for m in cell.end_to_end:
            if m["name"] in values and harness.finite(values[m["name"]]):
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": units[m["name"]]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": peak}
    brk = None
    if ctx.trace:
        dev["busy_s"] = harness.busy_seconds(out.trace.kernels)
        dev["window_s"] = out.trace.profiled_s
        brk = harness.breakdown(out.trace)
    correct = out.failed == 0 and bool(checks) and all(c["ok"] for c in checks)
    for k, v in out.notes.items():
        print(f"note {k}: {v}", file=sys.stderr)
    print(harness.checks_text(checks), file=sys.stderr, flush=True)
    print(harness.result_line(correct=correct, attempted=out.attempted, failed=out.failed,
                              metrics=metrics, device=dev, checks=checks, breakdown=brk),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
