"""Optimizer and learning-rate schedules (counterpart of
sar_tpu/training/optim.py, which builds them from optax).

- `make_schedule`: a linear warmup from lr * 1e-8 into a linear, cosine or
  constant stage, joined at `warmup_steps` as optax.join_schedules joins
  them (the stage after the boundary reads count - warmup_steps). The
  warmup is the JAX package's cancellation-free form,
  init * (1 - frac) + lr * frac. Values are computed in float32, as optax
  computes them.
- `decay_mask`: weight decay only on leaves of rank >= 2.
- `ClippedAdamW`: optax.chain(clip_by_global_norm, adamw) step by step:
  clip by the global norm the way optax does (t / norm * max_norm, and
  only when norm >= max_norm; torch's clip_grad_norm_ divides by
  norm + 1e-6 instead), then Adam's moments, their bias correction at the
  incremented count, u = m_hat / (sqrt(v_hat) + eps), the decay term
  u + wd * p on masked leaves, and the scale by -lr, where lr is the
  schedule read at the optimizer's own count (0 at the first update).

Parameters, gradients and the moments are nested dicts of fp32 tensors.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from sar_tpu_torch.models.whisper import tree_leaves, tree_map

Schedule = Callable[[int], float]


def make_schedule(kind: str, learning_rate: float, warmup_steps: int,
                  max_steps: int) -> Schedule:
    f32 = np.float32
    init = f32(learning_rate * 1e-8)
    lr = f32(learning_rate)
    steps = max(warmup_steps, 1)
    decay_steps = max(max_steps - warmup_steps, 1)

    def warmup(count: int) -> np.float32:
        frac = np.clip(f32(count) / f32(steps), f32(0.0), f32(1.0))
        return init * (f32(1.0) - frac) + lr * frac

    if kind == "linear":
        def decay(count: int) -> np.float32:
            c = f32(min(max(count, 0), decay_steps))
            return lr * (f32(1.0) - c / f32(decay_steps))
    elif kind == "cosine":
        def decay(count: int) -> np.float32:
            c = f32(min(count, decay_steps))
            cos = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * c / f32(decay_steps)))
            return lr * cos
    elif kind == "constant":
        def decay(count: int) -> np.float32:
            return lr
    else:
        raise ValueError(f"Unknown scheduler {kind!r} (linear|cosine|constant)")

    def schedule(count: int) -> float:
        count = int(count)
        return float(warmup(count) if count < warmup_steps
                     else decay(count - warmup_steps))
    return schedule


def decay_mask(params) -> dict:
    """True (apply weight decay) only for leaves of rank >= 2, the JAX
    package's stand-in for no decay on biases and LayerNorms."""
    return tree_map(lambda x: x.dim() >= 2, params)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (fp32, a 0-dim tensor)."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))


class ClippedAdamW:
    """Global-norm clipping then AdamW, with optax's arithmetic. State:
    {"count": int, "mu": tree, "nu": tree}."""

    def __init__(self, schedule: Schedule, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                 mask: Callable = decay_mask):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.mask = mask

    def init(self, params) -> dict:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(self, grads, state: dict, params):
        """-> (updates, new state); `apply_updates` adds the updates."""
        norm = global_norm(grads)
        clip = norm >= self.max_grad_norm
        grads = tree_map(lambda g: torch.where(clip, g / norm * self.max_grad_norm, g),
                         grads)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * g.square() + b2 * v, grads, state["nu"])
        count = state["count"] + 1
        bc1 = 1 - np.float32(b1) ** np.float32(count)
        bc2 = 1 - np.float32(b2) ** np.float32(count)
        updates = tree_map(lambda m, v: (m / float(bc1))
                           / (torch.sqrt(v / float(bc2)) + self.eps), mu, nu)
        wd = self.weight_decay
        updates = tree_map(lambda u, p, on: u + wd * p if on else u,
                           updates, params, self.mask(params))
        step = -np.float32(self.schedule(state["count"]))
        updates = tree_map(lambda u: u * float(step), updates)
        return updates, {"count": count, "mu": mu, "nu": nu}


@torch.no_grad()
def apply_updates(params, updates) -> None:
    """params += updates, in place (params keep their dtype)."""
    tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)


def make_optimizer(learning_rate: float = 5e-4, weight_decay: float = 0.01,
                   warmup_steps: int = 500, max_steps: int = 5000,
                   scheduler: str = "linear", max_grad_norm: float = 1.0,
                   ) -> tuple[ClippedAdamW, Schedule]:
    schedule = make_schedule(scheduler, learning_rate, warmup_steps, max_steps)
    return ClippedAdamW(schedule, weight_decay=weight_decay,
                        max_grad_norm=max_grad_norm), schedule
