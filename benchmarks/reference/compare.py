"""The comparisons that decide `correct`.

A served token is judged by the reference's logits at its position: the
gap by which the reference scores it below the reference's own best
token there. A greedy program whose arithmetic were exact would serve the
best token at every position, a gap of 0; rounding serves a near-tie now
and then, a small gap; a program that serves a wrong token reads a gap of
the order of the logits' spread. The number compared is the widest gap
over every served token of the sampled requests.
"""

from __future__ import annotations

import torch


def served_gaps(ref_logits: torch.Tensor, prompt_len: int, served: list[int]) -> torch.Tensor:
    """Gaps [n] of the served tokens: ref_logits [T, V] are teacher-forced
    over prompt + served, so row prompt_len - 1 + j scores served[j]."""
    rows = ref_logits[prompt_len - 1: prompt_len - 1 + len(served)]
    chosen = rows[torch.arange(len(served), device=rows.device),
                  torch.as_tensor(served, device=rows.device)]
    return rows.max(-1).values - chosen


def control_gaps(ref_logits: torch.Tensor, ctl_logits: torch.Tensor, prompt_len: int,
                 n: int) -> torch.Tensor:
    """Gaps [n] of the tokens that the control puts first at the same
    positions (teacher-forced on the same tokens): the control need not
    decode."""
    rows = slice(prompt_len - 1, prompt_len - 1 + n)
    ref, ctl = ref_logits[rows], ctl_logits[rows]
    chosen = ref.gather(-1, ctl.argmax(-1, keepdim=True))[:, 0]
    return ref.max(-1).values - chosen


def sample(items: list, k: int, rng, length) -> list:
    """k of the answered `items`: the one with the most served tokens
    (`length(item)`), then k - 1 others drawn by `rng` (numpy), in order."""
    if not items:
        return []
    longest = max(range(len(items)), key=lambda i: length(items[i]))
    rest = [i for i in range(len(items)) if i != longest]
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [items[longest]] + [items[rest[i]] for i in sorted(pick)]


def check(name: str, value: float, limit: float) -> dict:
    """One compared number beside its limit, which it may not exceed."""
    return {"name": name, "value": float(value), "limit": float(limit),
            "ok": bool(value <= limit)}
