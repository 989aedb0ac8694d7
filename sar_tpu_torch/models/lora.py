"""LoRA adapter banks in PyTorch (counterpart of sar_tpu/models/lora.py).

A bank holds the adapters of every language stacked per (layer, target):

    {"encoder": {"q": {"a": [L, A, d, r], "b": [L, A, r, d]}, "v": ...},
     "decoder": {"self_q": ..., "self_v": ..., "cross_q": ..., "cross_v": ...}}

so routed inference picks each utterance's adapter on the device
(`whisper.lora_delta`). Adapters of different ranks stack by zero-padding
to the largest rank, which leaves every delta unchanged.

The checkpoint format is the JAX package's: a directory with
`adapter_config.json` and `adapter_params.npz` (fp32, keys such as
`decoder/cross_v/a`), so a bank saved by either package loads in the other.
PEFT `save_pretrained` directories load through `models/convert.py`.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from sar_tpu_torch.models import convert
from sar_tpu_torch.models.config import WhisperConfig
from sar_tpu_torch.models.whisper import param_count as base_param_count
from sar_tpu_torch.models.whisper import tree_leaves

# target_modules name (PEFT convention) -> the per-stack hook keys.
_TARGET_MAP = {
    "q_proj": {"encoder": ("q",), "decoder": ("self_q", "cross_q")},
    "k_proj": {"encoder": ("k",), "decoder": ("self_k", "cross_k")},
    "v_proj": {"encoder": ("v",), "decoder": ("self_v", "cross_v")},
    "out_proj": {"encoder": ("o",), "decoder": ("self_o", "cross_o")},
}


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """r, alpha, dropout and targets; defaults as the JAX package's."""
    r: int = 16
    alpha: int = 32
    dropout: float = 0.1
    target_modules: tuple[str, ...] = ("q_proj", "v_proj")

    @property
    def scale(self) -> float:
        return self.alpha / self.r

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["target_modules"] = list(self.target_modules)
        return d

    @staticmethod
    def from_dict(d: dict) -> "LoraConfig":
        d = dict(d)
        d["target_modules"] = tuple(d.get("target_modules", ("q_proj", "v_proj")))
        return LoraConfig(**d)


def init_lora(generator: torch.Generator, cfg: WhisperConfig,
              lora_cfg: LoraConfig, num_adapters: int = 1,
              dtype: torch.dtype = torch.float32) -> dict:
    """A bank of `num_adapters` adapters drawn from `generator` on its own
    device: A ~ N(0, 1) / r, B = 0, so every delta starts at exactly 0."""
    g = generator
    d, r, A = cfg.d_model, lora_cfg.r, num_adapters
    bank: dict[str, Any] = {"encoder": {}, "decoder": {}}

    def entry(L):
        a = torch.randn((L, A, d, r), generator=g, device=g.device) / r
        return {"a": a.to(dtype),
                "b": torch.zeros((L, A, r, d), dtype=dtype, device=g.device)}

    for t in lora_cfg.target_modules:
        if t not in _TARGET_MAP:
            raise ValueError(f"Unsupported LoRA target {t!r}; "
                             f"choices: {sorted(_TARGET_MAP)}")
        for hook in _TARGET_MAP[t]["encoder"]:
            bank["encoder"][hook] = entry(cfg.encoder_layers)
        for hook in _TARGET_MAP[t]["decoder"]:
            bank["decoder"][hook] = entry(cfg.decoder_layers)
    return bank


def map_with_path(fn, tree: dict, path=()) -> dict:
    """tree_map with the key path handed to `fn(path, leaf)`."""
    return {k: (map_with_path(fn, v, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v)) for k, v in tree.items()}


def param_count(lora: dict) -> int:
    return sum(x.numel() for x in tree_leaves(lora))


def trainable_summary(lora: dict, base_params: dict) -> dict:
    """The trainable share of base + adapter (the JAX package's log line)."""
    n_lora, n_base = param_count(lora), base_param_count(base_params)
    return {"trainable_params": n_lora,
            "total_params": n_base + n_lora,
            "trainable_percent": 100.0 * n_lora / (n_base + n_lora)}


def num_adapters(lora: dict) -> int:
    return tree_leaves(lora)[0].shape[1]


def rank(lora: dict) -> int:
    return tree_leaves(lora)[0].shape[-1]


def slice_adapter(lora: dict, index: int) -> dict:
    """One adapter of a bank (A -> 1), as views."""
    return map_with_path(lambda _, x: x[:, index:index + 1], lora)


def stack_adapters(adapters: list[dict], pad_to_rank: int | None = None) -> dict:
    """Stack single-adapter banks, possibly of different ranks, into one
    bank; each is zero-padded to the largest rank (same deltas)."""
    max_r = pad_to_rank or max(rank(a) for a in adapters)

    def pad(path, x):
        if path[-1] == "a":                                  # [L, 1, d, r]
            return F.pad(x, (0, max_r - x.shape[-1]))
        return F.pad(x, (0, 0, 0, max_r - x.shape[-2]))     # b: [L, 1, r, d]

    padded = [map_with_path(pad, a) for a in adapters]

    def cat(tree_list):
        first = tree_list[0]
        if isinstance(first, dict):
            return {k: cat([t[k] for t in tree_list]) for k in first}
        return torch.cat(tree_list, dim=1)
    return cat(padded)


def merge_lora(params: dict, lora: dict, lora_cfg: LoraConfig,
               adapter_index: int = 0) -> dict:
    """Fold one adapter into the base weights (W += scale * A @ B); the
    input trees are left as they are."""
    merged = {side: dict(params[side], layers=dict(params[side]["layers"]))
              if side in ("encoder", "decoder") else params[side]
              for side in params}
    for side in ("encoder", "decoder"):
        for hook, entry in lora.get(side, {}).items():
            a = entry["a"][:, adapter_index].float()           # [L, d, r]
            b = entry["b"][:, adapter_index].float()           # [L, r, d]
            delta = lora_cfg.scale * torch.matmul(a, b)
            old = merged[side]["layers"][hook]
            w = old["w"]
            merged[side]["layers"][hook] = dict(old, w=w + delta.to(w.dtype))
    return merged


# ---------------------------------------------------------------------------
# Checkpoints: adapter_config.json + adapter_params.npz (fp32)
# ---------------------------------------------------------------------------

def save_adapter(path: str | Path, lora: dict, lora_cfg: LoraConfig,
                 metadata: dict | None = None) -> None:
    """Save an adapter (or a bank) to the directory `path`."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    cfg = {"lora": lora_cfg.to_dict(), "metadata": metadata or {}}
    (path / "adapter_config.json").write_text(json.dumps(cfg, indent=2))
    np.savez(path / "adapter_params.npz", **convert.flatten(lora))


def load_adapter(path: str | Path, device: torch.device | str = "cpu"
                 ) -> tuple[dict, LoraConfig, dict]:
    """An adapter directory -> (bank on `device`, LoraConfig, metadata)."""
    path = Path(path)
    cfg = json.loads((path / "adapter_config.json").read_text())
    with np.load(path / "adapter_params.npz") as z:
        lora = convert.from_jax_params(
            convert.unflatten({k: z[k] for k in z.files}), device)
    return lora, LoraConfig.from_dict(cfg["lora"]), cfg.get("metadata", {})


def load_any_adapter(path: str | Path, model_cfg: WhisperConfig,
                     device: torch.device | str = "cpu"
                     ) -> tuple[dict, LoraConfig, dict]:
    """A sar_tpu / sar_tpu_torch adapter directory or a PEFT
    `save_pretrained` directory -> (bank, LoraConfig, metadata).
    `model_cfg` gives the layer counts for the PEFT import."""
    path = Path(path)
    if convert.is_peft_checkpoint(path):
        bank, lcfg = convert.lora_from_peft(path, model_cfg)
        return convert.from_jax_params(bank, device), lcfg, {"format": "peft"}
    return load_adapter(path, device)
