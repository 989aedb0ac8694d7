"""The control of a cell's `correct`: the plain reference put in the
program's place at float8 e4m3 (the step below the configurations'
bfloat16), read on the same prompts and served tokens as the program's own
run, seed by seed, in one process.

    python3 -m benchmarks.control --workload <cell> --seconds <s> --seeds 1 2 3

Prints, per seed, each compared number of the program's run and the
control's reading beside the cell's limit; the control must fail one. With
`--fault <name>` the program runs with that fault planted (the cell
driver's `ctx.fault`) and its own numbers are read instead. Not part of a
benchmark run; `tests/test_bench_control_cuda.py` runs it on the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from benchmarks import harness


def readings(cell: str, seeds, seconds: float, device, fault: str | None = None,
             root=harness.ROOT):
    """Yield (seed, compared numbers) per seed: the program's, and the
    control's beside them unless a fault is planted."""
    c = harness.load_cell(cell, root)
    driver = harness.load_driver(c.workload["driver"], root)
    for seed in seeds:
        out = driver.run(harness.Context(cell=c, seed=seed, seconds=seconds, trace=False,
                                         device=device, fault=fault))
        out.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        yield seed, out.check(control=fault is None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None,
                   help="plant a fault in the program instead (a name the cell's driver knows)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    for seed, checks in readings(args.workload, args.seeds, args.seconds, device, args.fault):
        print(json.dumps({"cell": args.workload, "seed": seed, "fault": args.fault,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
