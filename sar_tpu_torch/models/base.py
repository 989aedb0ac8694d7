"""Model loading (the `load_base_model` part of sar_tpu/models/base.py).

`whisper-test` is a random init from a seeded `torch.Generator`. Real
Whisper sizes wait for weights in the repository: their HF checkpoints
would need a download, so asking for one raises and says so.
"""

from __future__ import annotations

import torch

from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import WhisperConfig, get_config


def load_base_model(model_name: str, dtype: torch.dtype = torch.bfloat16,
                    seed: int = 0, device: torch.device | str = "cpu"
                    ) -> tuple[WhisperConfig, dict]:
    """(cfg, params) for `whisper-test`: weights drawn on the CPU from
    `torch.Generator().manual_seed(seed)` (the same on every machine),
    then moved to `device` and cast to `dtype` (LayerNorms stay fp32)."""
    cfg = get_config(model_name)
    if model_name != "whisper-test":
        raise NotImplementedError(
            f"{model_name}: real Whisper weights wait for a checkpoint in the "
            f"repository (the HF download is not available); use "
            f"--model whisper-test, or build params with "
            f"sar_tpu_torch.models.whisper.init_params")
    params = whisper.init_params(cfg, torch.Generator().manual_seed(seed), device)
    if dtype != torch.float32:
        params = whisper.cast_params(params, dtype)
    return cfg, params
