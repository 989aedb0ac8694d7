"""Seeded audio clips: durations from a fixed grid, noise from the seed.

Every seed gets the same multiset of clip durations (a grid over the
workload's range), in its own order, and its own samples, so runs of two
seeds do the same work. Samples are drawn on the device with a torch
generator in one call per batch and handed over as host float32 arrays,
as a user's loader would hand them: a [B, N] array when every clip fills
the 30 s window, else a list of 1-D clips of their own lengths.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

SAMPLE_RATE = 16_000
WINDOW_SAMPLES = 30 * SAMPLE_RATE
AMPLITUDE = 0.1


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, *stream])


def duration_grid(n: int, lo: float, hi: float) -> np.ndarray:
    """n durations evenly over [lo, hi] (the midpoints of n equal bins)."""
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


@dataclass
class Batch:
    clips: object            # [B, N] float32 array, or a list of 1-D arrays
    durations: np.ndarray    # seconds of each clip
    languages: list | None = None   # each clip's language, where the mix has several

    def clip(self, i: int) -> np.ndarray:
        c = self.clips[i]
        return np.asarray(c, np.float32)


def noise(n_rows: int, n_samples: int, seed: int, stream: int,
          device: torch.device) -> np.ndarray:
    from benchmarks.weights import generator
    g = generator(seed, device, stream=stream)
    x = torch.randn((n_rows, n_samples), generator=g, device=device).mul_(AMPLITUDE)
    return x.cpu().numpy()


def batch(traffic: dict, seed: int, index: int, device: torch.device) -> Batch:
    """Batch `index` of an evaluation mix: `batch` clips with durations
    from the grid over [min_s, max_s], shuffled by (seed, index); with
    `languages`, each clip's language from that list, every language the
    same number of times (as near as B allows), in a seeded order."""
    B = traffic["batch"]
    durs = duration_grid(B, traffic["min_s"], traffic["max_s"])
    durs = durs[rng(seed, 7, index).permutation(B)]
    langs = traffic.get("languages")
    if langs:
        langs = [langs[i % len(langs)] for i in rng(seed, 23, index).permutation(B)]
    n = np.round(durs * SAMPLE_RATE).astype(np.int64)
    x = noise(B, int(n.max()), seed, 1000 + index, device)
    if np.all(n == WINDOW_SAMPLES):
        return Batch(x, durs, langs)
    return Batch([x[i, :n[i]] for i in range(B)], durs, langs)
