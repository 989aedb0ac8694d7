"""The rate sweep of a serving cell: the same service under open loops at
a list of fixed rates, one after another in one process, to find the
highest rate it sustains without a growing backlog. Run once on the card;
the cell's fixed rate (0.8 of that) is then written into its workload
file as a number.

    python3 -m benchmarks.sweep_rate --workload small.serve.routed \\
        --seconds 30 --rates 8 10 12 14 16 18 20

Prints one JSON line per rate: requests, answered, completed per second,
p50 and p95 from due time, and the backlog's growth (the median latency of
the last quarter of the requests over the first quarter's).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmarks import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 1
    cell = harness.load_cell(args.workload)
    serve = harness.load_driver(cell.workload["driver"])
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=False,
                          device=torch.device("cuda", 0))
    svc, _ = serve.build(ctx)
    w = cell.workload
    try:
        first = serve.Traffic(w["traffic"], args.seed, 2.0, ctx.device)
        serve.warm_up(svc, first, 2, w["service"]["batch_size"], [])
        for k, rate in enumerate(args.rates):
            t = serve.Traffic(dict(w["traffic"], rate_per_s=rate), args.seed + k,
                              args.seconds, ctx.device)
            before = svc.stats()
            res = serve.open_loop(svc, t, w["grace_s"])
            after = svc.stats()
            lat = serve.arrivals.latencies_ms(res["due"], res["done"])
            ok = ~np.isnan(lat)
            q = max(1, t.n // 4)
            span = float(np.nanmax(res["done"]) - res["t0"]) if ok.any() else float("nan")
            print(json.dumps({
                "rate_per_s": rate, "requests": t.n, "answered": int(ok.sum()),
                "completed_per_s": float(ok.sum() / span),
                "p50_ms": serve.arrivals.percentile(lat, 50),
                "p95_ms": serve.arrivals.percentile(lat, 95),
                "backlog_growth": float(np.nanmedian(lat[-q:]) / np.nanmedian(lat[:q])),
                "batches": after["batches"] - before["batches"],
                "batch_fill_pct": 100.0 * (after["rows_served"] - before["rows_served"])
                / max(1, after["batches"] - before["batches"]) / w["service"]["batch_size"],
                "time": time.strftime("%H:%M:%S")}), flush=True)
    finally:
        svc.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
