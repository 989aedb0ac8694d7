"""Batched greedy transcription (counterpart of the greedy int8 part of
sar_tpu/evaluation/evaluator.py::ASREvaluator), with or without one LoRA
adapter.

Two phases per batch, as in the reference: `prep` (encoder + the int8
head-minor cross-KV cache) and `dec` (the greedy loop over that cache).
Results are token-id lists; text only when a tokenizer is given. Beams,
meshes, fallback, int4 KV and int8 scores are later slices of the port and
raise NotImplementedError here.

The evaluator runs on the CUDA card unless `device` says otherwise (see
sar_tpu_torch/device.py); params and the adapter on another device are
moved to its device once, here.
"""

from __future__ import annotations

import numpy as np
import torch

from sar_tpu_torch.decode.greedy import greedy_decode_from_cache, transcribe_tokens
from sar_tpu_torch.device import resolve_device, tree_to
from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import WhisperConfig
from sar_tpu_torch.ops import mel as mel_ops


class ASREvaluator:
    """Greedy int8-KV transcription of whole batches on one device.

    `lora` is a bank whose adapter 0 adapts every row (a single adapter, as
    the JAX evaluator takes it), with `lora_scale` = alpha / r; its cross_v
    term rides kernel K4 in its broadcast form."""

    def __init__(self, cfg: WhisperConfig, params: dict, tokenizer=None,
                 language: str = "hindi", max_new_tokens: int = 256,
                 num_beams: int = 1, lora: dict | None = None,
                 lora_scale: float = 1.0,
                 kv_int8: bool = True, mesh=None,
                 flash: str | bool = "auto", scores_int8: bool = False,
                 prompt_tokens=None, fallback: bool = False,
                 task: str = "transcribe", kv_int4: bool = False,
                 device: torch.device | str | None = None,
                 kernels: bool = True):
        lacking = {"num_beams > 1": num_beams != 1,
                   "kv_int8=False": not kv_int8, "mesh": mesh is not None,
                   "scores_int8": scores_int8, "fallback": fallback,
                   "kv_int4": kv_int4}
        missing = [name for name, asked in lacking.items() if asked]
        if missing:
            raise NotImplementedError(
                f"sar_tpu_torch ASREvaluator has greedy int8-KV decode only; "
                f"not yet ported: {', '.join(missing)}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.dtype = self.params["encoder"]["conv1"]["w"].dtype
        # Cast once to the compute dtype: lora_delta casts to it anyway.
        self.lora = (tree_to(lora, self.device, self.dtype)
                     if lora is not None else None)
        self.lora_scale = lora_scale
        self.tokenizer = tokenizer
        self.language = language
        self.max_new_tokens = max_new_tokens
        self.kernels = kernels
        # "auto": the head-minor attention kernel on the card, exact
        # attention on the CPU (the kernel's plain version is slower there).
        self.flash = (("hm" if self.device.type == "cuda" else False)
                      if flash == "auto" else flash)
        prompt = (list(prompt_tokens) if prompt_tokens is not None
                  else cfg.prompt_ids(language, task))
        self._prompt = torch.tensor(prompt, dtype=torch.int64, device=self.device)
        self.total = min(len(prompt) + max_new_tokens, cfg.max_target_positions)

    def prep(self, mel: torch.Tensor) -> whisper.DecodeCache:
        """Encoder + cross-KV projection/quantization for one batch."""
        with torch.no_grad():
            enc = whisper.encode(self.params, mel.to(self.device), self.cfg,
                                 lora=self.lora, lora_scale=self.lora_scale,
                                 flash=self.flash)
            return whisper.init_cache(self.params, enc, self.cfg,
                                      max_len=self.total, lora=self.lora,
                                      lora_scale=self.lora_scale,
                                      kernels=self.kernels)

    def dec(self, cache: whisper.DecodeCache, prompts=None) -> torch.Tensor:
        """The greedy loop over a prepared cache -> tokens [B, total].
        `prompts` [B, P] gives each row its own prompt (default: the
        evaluator's)."""
        prompts = self._prompt if prompts is None else prompts
        return greedy_decode_from_cache(self.params, cache, self.cfg, prompts,
                                        lora=self.lora,
                                        lora_scale=self.lora_scale,
                                        kernels=self.kernels)

    def _transcribe_batch(self, mel: torch.Tensor) -> list:
        tokens = self.dec(self.prep(mel))
        ids = transcribe_tokens(tokens, self.cfg,
                                prompt_len=int(self._prompt.shape[0]))
        if self.tokenizer is None:
            return ids
        return [self.tokenizer.decode(row) for row in ids]

    def from_audio(self, audio) -> list:
        """Raw 16 kHz audio ([B, N] array/tensor, or a list of 1-D
        waveforms) -> per-clip token ids (or text): pad/trim to the 30 s
        window, log-mel on the device in the params' dtype, keep the
        encoder's `num_audio_frames` frames, then prep + dec."""
        if isinstance(audio, (list, tuple)):
            audio = mel_ops.stack_pad_audio(audio)
        if not isinstance(audio, torch.Tensor):
            audio = torch.from_numpy(np.asarray(audio, np.float32))
        audio = audio.to(self.device, torch.float32)
        feats = mel_ops.log_mel_spectrogram(
            mel_ops.pad_or_trim(audio), self.cfg.num_mel_bins, dtype=self.dtype)
        return self._transcribe_batch(feats[:, :, :self.cfg.num_audio_frames])
