"""Checkpoint save/load (counterpart of sar_tpu/training/checkpoints.py).

A checkpoint directory holds `adapter/` (the adapter bank in the JAX
package's directory format, `lora.save_adapter`, so either package loads
it) and `train_state.pt` (a torch file: the optimizer state, global_step,
epoch and best_metric). `load_checkpoint` restores the weights AND the
optimizer, as the JAX package does. Orbax train states of the JAX package
are not read.
"""

from __future__ import annotations

from pathlib import Path

import torch

from sar_tpu_torch.models import lora as lora_lib
from sar_tpu_torch.models.whisper import tree_map


def save_checkpoint(path: str | Path, lora: dict, lora_cfg, opt_state: dict,
                    global_step: int, epoch: int = 0,
                    best_metric: float | None = None,
                    metadata: dict | None = None) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    lora_lib.save_adapter(path / "adapter", lora, lora_cfg, metadata=metadata)
    cpu = lambda x: x.detach().cpu()
    state = {"opt_state": {"count": int(opt_state["count"]),
                           "mu": tree_map(cpu, opt_state["mu"]),
                           "nu": tree_map(cpu, opt_state["nu"])},
             "global_step": int(global_step), "epoch": int(epoch),
             "best_metric": best_metric}
    torch.save(state, path / "train_state.pt")


def load_checkpoint(path: str | Path, device: torch.device | str = "cpu"):
    """-> (lora, lora_cfg, metadata, opt_state, global_step, epoch,
    best_metric), tensors on `device`."""
    path = Path(path)
    lora, lora_cfg, metadata = lora_lib.load_adapter(path / "adapter", device)
    state = torch.load(path / "train_state.pt", map_location=device,
                       weights_only=True)
    return (lora, lora_cfg, metadata, state["opt_state"],
            state["global_step"], state["epoch"], state["best_metric"])
