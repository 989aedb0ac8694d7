"""Open-loop arrival schedules from a seed.

Poisson arrivals at a fixed rate, made so that every seed offers the same
load: the gaps are the n quantiles of the exponential distribution at the
rate, (-ln(1 - (i + 0.5) / n) / rate), in an order drawn from the seed.
The schedule's length and the multiset of gaps are the same for every
seed; the order, and so the bursts, differ. Each request has a due time;
its latency runs from that due time to its result, so a generator that
falls behind counts against the system, not for it.
"""

from __future__ import annotations

import numpy as np

from benchmarks.traffic.audio import rng


def exponential_gaps(n: int, rate: float) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def schedule(n: int, rate: float, seed: int) -> np.ndarray:
    """Due times (s, from 0) of n requests at `rate` per second: the first
    due at its gap."""
    gaps = exponential_gaps(n, rate)[rng(seed, 11).permutation(n)]
    return np.cumsum(gaps)


def latencies_ms(due: np.ndarray, done: np.ndarray) -> np.ndarray:
    """Milliseconds from each due time to its result (both in seconds on
    one clock); NaN where no result came."""
    return (np.asarray(done, float) - np.asarray(due, float)) * 1e3


def percentile(values: np.ndarray, q: float) -> float:
    """The q-th percentile of all requests, a missing one (NaN) counted as
    slower than any answered: it is inf when more than (100 - q)% are
    missing."""
    v = np.where(np.isnan(values), np.inf, values)
    return float(np.percentile(v, q, method="higher"))
