"""Where the port's entry points run.

`ASREvaluator`, `AdapterRouter` and `TranscriptionService` run on the CUDA
card unless the caller passes `device="cpu"` (or another device). With no
device given and no CUDA device present they raise: nothing carries on
silently on the CPU. Parameters that lie elsewhere are moved to the entry
point's device once, when it is built.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The entry point's device: `device` as given, else the current CUDA
    device; raises when none was given and CUDA is absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the sar_tpu_torch entry points run on the "
                "card by default; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def tree_to(tree, device: torch.device | None = None,
            dtype: torch.dtype | None = None):
    """A nested dict of tensors moved to `device` and/or cast to `dtype`
    (floating leaves only); leaves already there are returned as they are."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if dtype is not None and tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device=device)
