"""Model and processor loading (counterpart of sar_tpu/models/base.py).

`load_base_model` gives `whisper-test` a random init from a seeded
`torch.Generator`. A real Whisper size is read from the local HF cache
only (`local_files_only=True`, never the network), converted with
`convert.from_hf_model`, moved to the device and cast; without
`transformers` or without the checkpoint's files it raises and names the
missing weights. `get_processor` is the port's (feature function,
tokenizer) pair: Whisper's mel frontend on a device and `get_tokenizer`.
"""

from __future__ import annotations

import logging

import torch

from sar_tpu_torch.data.tokenizer import get_tokenizer
from sar_tpu_torch.device import resolve_device
from sar_tpu_torch.models import convert, whisper
from sar_tpu_torch.models.config import HF_MODEL_IDS, WhisperConfig, get_config

logger = logging.getLogger(__name__)


def get_model_name(short_name: str) -> str:
    """Registry short name -> HF hub id (other names pass through)."""
    return HF_MODEL_IDS.get(short_name, short_name)


def get_processor(model_name: str, language: str = "hindi",
                  task: str = "transcribe",
                  device: torch.device | str | None = None):
    """(features, tokenizer): `features(audio)` takes 16 kHz audio [N] or
    [B, N] (numpy or torch, padded or trimmed to the 30 s window by the
    caller) and returns log-mel features [B, num_mel_bins, 3000] fp32 on
    `device` (the CUDA card unless given); the tokenizer is
    `get_tokenizer(model_name, language, task)`. A config with ESPnet's
    frontend (OWSM) raises ValueError: its features need the checkpoint's
    MVN statistics, which only its params hold (models/frontend.py)."""
    from sar_tpu_torch.ops.mel import log_mel_spectrogram
    cfg = get_config(model_name)
    if cfg.frontend != "whisper":
        raise ValueError(
            f"{model_name}: its {cfg.frontend} frontend normalises with the "
            f"checkpoint's MVN statistics, params['mvn'], which get_processor "
            f"does not hold; use sar_tpu_torch.models.frontend.features(audio, "
            f"cfg, params, ...)")
    dev = resolve_device(device)
    tok = get_tokenizer(model_name, language=language, task=task)

    def features(audio) -> torch.Tensor:
        return log_mel_spectrogram(torch.as_tensor(audio).to(dev),
                                   num_mels=cfg.num_mel_bins)

    return features, tok


def _hf_weights(model_name: str, cfg: WhisperConfig, device) -> dict:
    """The HF checkpoint of a registry model from the local HF cache,
    converted; NotImplementedError naming what is missing otherwise."""
    hf_id = HF_MODEL_IDS[model_name]
    try:
        from transformers import WhisperForConditionalGeneration
        hf = WhisperForConditionalGeneration.from_pretrained(
            hf_id, local_files_only=True)
    except (ImportError, OSError) as e:
        raise NotImplementedError(
            f"{model_name}: real Whisper weights ({hf_id}) are not available "
            f"offline: they need `transformers` and the checkpoint's files "
            f"in the local HF cache ({type(e).__name__}: {e}); use --model "
            f"whisper-test, or build params with "
            f"sar_tpu_torch.models.whisper.init_params") from e
    logger.info("loaded HF weights %s from the local cache", hf_id)
    return convert.from_hf_model(hf, cfg, device)


def load_base_model(model_name: str, dtype: torch.dtype = torch.bfloat16,
                    seed: int = 0, device: torch.device | str = "cpu"
                    ) -> tuple[WhisperConfig, dict]:
    """(cfg, params) on `device` in `dtype` (LayerNorms stay fp32).
    `whisper-test` draws its weights on the CPU from
    `torch.Generator().manual_seed(seed)` (the same on every machine); a
    real size converts its HF checkpoint from the local cache."""
    cfg = get_config(model_name)
    if model_name == "whisper-test":
        params = whisper.init_params(cfg, torch.Generator().manual_seed(seed), device)
    else:
        params = _hf_weights(model_name, cfg, device)
    if dtype != torch.float32:
        params = whisper.cast_params(params, dtype)
    return cfg, params
