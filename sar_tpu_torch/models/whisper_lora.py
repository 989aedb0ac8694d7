"""The user-facing WhisperLoRA handle (counterpart of
sar_tpu/models/whisper_lora.py): base model + one adapter (or a bank) +
tokenizer, with forward / generate / transcribe / save_adapter /
load_adapter / merge_and_unload, the factory `create_whisper_lora` and
`load_whisper_lora_from_checkpoint`.

The handle is a shell over the functional APIs (models/whisper.py,
decode/); the trainer and the evaluator call those directly. It lives on
the CUDA card unless given `device` (sar_tpu_torch/device.py). Real
Whisper sizes wait for weights in the repository, as in models/base.py.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

from sar_tpu_torch.data.tokenizer import get_tokenizer
from sar_tpu_torch.decode.beam import beam_decode
from sar_tpu_torch.decode.greedy import greedy_decode, transcribe_tokens
from sar_tpu_torch.device import resolve_device, tree_to
from sar_tpu_torch.models import lora as lora_lib
from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.base import load_base_model
from sar_tpu_torch.models.config import WhisperConfig

logger = logging.getLogger(__name__)


class WhisperLoRA:
    """Base Whisper + one LoRA adapter (or bank), ready to transcribe."""

    def __init__(self, cfg: WhisperConfig, base_params: dict, lora: dict,
                 lora_cfg: lora_lib.LoraConfig, tokenizer=None,
                 language: str = "hindi",
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.base_params = tree_to(base_params, self.device)
        self.lora = tree_to(lora, self.device)
        self.lora_cfg = lora_cfg
        self.tokenizer = tokenizer
        self.language = language
        summary = lora_lib.trainable_summary(lora, base_params)
        logger.info("WhisperLoRA: %.3f%% trainable (%d of %d params)",
                    summary["trainable_percent"], summary["trainable_params"],
                    summary["total_params"])

    def _mel(self, mel) -> torch.Tensor:
        dtype = self.base_params["encoder"]["conv1"]["w"].dtype
        return torch.as_tensor(mel).to(self.device, dtype)

    # -- compute -----------------------------------------------------------
    def forward(self, mel, labels) -> dict:
        """Teacher-forced forward -> {"logits", "loss"}."""
        labels = torch.as_tensor(labels).to(self.device).long()
        dec_in = whisper.shift_tokens_right(labels, self.cfg.sot_token_id,
                                            self.cfg.pad_token_id)
        logits = whisper.forward(self.base_params, self._mel(mel), dec_in,
                                 self.cfg, lora=self.lora,
                                 lora_scale=self.lora_cfg.scale)
        return {"logits": logits,
                "loss": whisper.cross_entropy_loss(logits, labels)}

    @torch.no_grad()
    def generate(self, mel, max_new_tokens: int = 256, num_beams: int = 1,
                 language: str | None = None) -> torch.Tensor:
        """Batched transcription token ids (greedy by default)."""
        prompt = self.cfg.prompt_ids(language or self.language)
        enc = whisper.encode(self.base_params, self._mel(mel), self.cfg,
                             lora=self.lora, lora_scale=self.lora_cfg.scale)
        if num_beams > 1:
            return beam_decode(self.base_params, enc, self.cfg, prompt,
                               num_beams=num_beams,
                               max_new_tokens=max_new_tokens, lora=self.lora,
                               lora_scale=self.lora_cfg.scale)
        return greedy_decode(self.base_params, enc, self.cfg, prompt,
                             max_new_tokens=max_new_tokens, lora=self.lora,
                             lora_scale=self.lora_cfg.scale)

    def transcribe(self, mel, **kw) -> list[str]:
        tokens = self.generate(mel, **kw)
        prompt_len = len(self.cfg.prompt_ids(kw.get("language") or self.language))
        ids = transcribe_tokens(tokens, self.cfg, prompt_len=prompt_len)
        return [self.tokenizer.decode(r) for r in ids]

    # -- persistence ---------------------------------------------------------
    def save_adapter(self, path: str | Path) -> None:
        lora_lib.save_adapter(path, self.lora, self.lora_cfg,
                              metadata={"language": self.language,
                                        "model": self.cfg.name})

    def load_adapter(self, path: str | Path) -> None:
        self.lora, self.lora_cfg, meta = lora_lib.load_adapter(path, self.device)
        self.language = meta.get("language", self.language)

    def merge_and_unload(self) -> dict:
        """The base params with adapter 0 folded into their weights."""
        return lora_lib.merge_lora(self.base_params, self.lora, self.lora_cfg)


def create_whisper_lora(model_name: str = "whisper-small",
                        language: str = "hindi", lora_rank: int = 16,
                        lora_alpha: int = 32, lora_dropout: float = 0.1,
                        target_modules=("q_proj", "v_proj"),
                        dtype: torch.dtype = torch.bfloat16, seed: int = 42,
                        device: torch.device | str | None = None) -> WhisperLoRA:
    """A fresh adapter (A from a generator seeded with `seed`, B = 0) on the
    base model."""
    cfg, params = load_base_model(model_name, dtype=dtype)
    lcfg = lora_lib.LoraConfig(r=lora_rank, alpha=lora_alpha,
                               dropout=lora_dropout,
                               target_modules=tuple(target_modules))
    bank = lora_lib.init_lora(torch.Generator().manual_seed(seed), cfg, lcfg)
    tok = get_tokenizer(model_name, language=language)
    return WhisperLoRA(cfg, params, bank, lcfg, tokenizer=tok,
                       language=language, device=device)


def load_whisper_lora_from_checkpoint(checkpoint: str | Path,
                                      model_name: str = "whisper-small",
                                      language: str | None = None,
                                      dtype: torch.dtype = torch.bfloat16,
                                      device: torch.device | str | None = None
                                      ) -> WhisperLoRA:
    """Base + adapter from a training checkpoint directory (its `adapter/`)
    or an adapter directory."""
    ckpt = Path(checkpoint)
    adapter_dir = ckpt / "adapter" if (ckpt / "adapter").exists() else ckpt
    bank, lcfg, meta = lora_lib.load_adapter(adapter_dir)
    language = language or meta.get("language", "hindi")
    cfg, params = load_base_model(model_name, dtype=dtype)
    tok = get_tokenizer(model_name, language=language)
    return WhisperLoRA(cfg, params, bank, lcfg, tokenizer=tok,
                       language=language, device=device)
