"""Batched transcription and corpus WER/CER (counterpart of
sar_tpu/evaluation/evaluator.py::ASREvaluator, int8-KV or int4-KV greedy
and beam decoding, with or without one LoRA adapter).

Greedy runs two phases per batch, as in the reference: `prep` (encoder +
the int8 head-minor cross-KV cache, or the int4 classic one) and `dec`
(the greedy loop over that cache). Beam search (`num_beams` > 1) runs the
encoder alone and then `beam_decode`, which builds its own cache (one
cross slab per sample, B*K self-cache rows). Both pass the cache flags
(`kv_int8`, `kv_int4`) to the decode explicitly, as the JAX evaluator
does: the decode functions' own default is the unquantized cache.
`flash` goes to `encode` as in the JAX evaluator: "hm" (kernel K1), "fq"
(kernel K8, which `encode` turns into "hm" when an adapter holds q/k/v),
False or True; "auto" is "hm" on the card. `evaluate` transcribes a
dataloader's split and returns corpus WER/CER; `evaluate_per_sample`,
`analyze` and `save_results` are the JAX evaluator's. The opt-in
quantized decode is the JAX evaluator's too: `scores_int8` (s8 scores
over the int8 cache, kernel K7) and `kv_int4` (the nibble-packed int4
cache, which supersedes kv_int8), with its checks
(`quantized_decode_options`). Meshes, temperature fallback and a bf16
cache (kv_int8=False) are not ported and raise NotImplementedError.

The evaluator runs on the CUDA card unless `device` says otherwise (see
sar_tpu_torch/device.py); params and the adapter on another device are
moved to its device once, here. Results are text when a tokenizer is
given, else token-id lists.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from sar_tpu_torch.decode.beam import beam_decode
from sar_tpu_torch.decode.greedy import greedy_decode_from_cache, transcribe_tokens
from sar_tpu_torch.device import resolve_device, tree_to
from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import WhisperConfig
from sar_tpu_torch.ops import mel as mel_ops
from sar_tpu_torch.training.metrics import (analyze_errors, compute_metrics,
                                            compute_metrics_per_sample)

logger = logging.getLogger(__name__)


def quantized_decode_options(kv_int8: bool, kv_int4: bool,
                             scores_int8: bool) -> tuple[bool, bool]:
    """The JAX evaluator's rules for the quantized decode flags: int4
    supersedes int8, and scores_int8 needs the int8 cache (so it does not
    compose with int4). Returns the effective (kv_int8, kv_int4); raises
    ValueError with the JAX package's messages."""
    kv_int8 = kv_int8 and not kv_int4
    if scores_int8 and kv_int4:
        raise ValueError("scores_int8 (the s8-MXU path) does not compose "
                         "with an int4-packed KV cache")
    if scores_int8 and not kv_int8:
        raise ValueError("scores_int8 requires kv_int8=True")
    return kv_int8, kv_int4


class ASREvaluator:
    """Greedy or beam int8-KV (or int4-KV) transcription of whole batches
    on one device.

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
        lacking = {"kv_int8=False (a bf16 cache)": not (kv_int8 or kv_int4),
                   "mesh": mesh is not None, "fallback": fallback}
        missing = [name for name, asked in lacking.items() if asked]
        if missing:
            raise NotImplementedError(
                f"sar_tpu_torch ASREvaluator has int8-KV and int4-KV greedy "
                f"and beam decoding only; not yet ported: {', '.join(missing)}")
        if num_beams < 1:
            raise ValueError(f"num_beams must be >= 1, got {num_beams}")
        self.kv_int8, self.kv_int4 = quantized_decode_options(
            kv_int8, kv_int4, scores_int8)
        if scores_int8 and num_beams > 1:
            logger.info("beams + scores_int8 fold each sample's beams into "
                        "one s8 cross-attention call (K7) and reorder the "
                        "self cache physically each step")
        self.scores_int8 = scores_int8
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
        self.num_beams = num_beams
        self.kernels = kernels
        # "auto": the head-minor attention kernel on the card, exact
        # attention on the CPU (the kernel's plain version is slower there).
        self.flash = (("hm" if self.device.type == "cuda" else False)
                      if flash == "auto" else flash)
        prompt = (list(prompt_tokens) if prompt_tokens is not None
                  else cfg.prompt_ids(language, task))
        self._prompt = torch.tensor(prompt, dtype=torch.int64, device=self.device)
        self.total = min(len(prompt) + max_new_tokens, cfg.max_target_positions)

    @torch.no_grad()
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """The (adapted) encoder over a batch of log-mel features."""
        return whisper.encode(self.params, mel.to(self.device), self.cfg,
                              lora=self.lora, lora_scale=self.lora_scale,
                              flash=self.flash)

    @torch.no_grad()
    def prep(self, mel: torch.Tensor) -> whisper.DecodeCache:
        """Encoder + cross-KV projection/quantization for one batch."""
        return whisper.init_cache(self.params, self.encode(mel), self.cfg,
                                  max_len=self.total, lora=self.lora,
                                  lora_scale=self.lora_scale,
                                  cross_kv_int8=self.kv_int8,
                                  self_kv_int8=self.kv_int8,
                                  cross_kv_int4=self.kv_int4,
                                  self_kv_int4=self.kv_int4,
                                  kernels=self.kernels)

    def dec(self, cache: whisper.DecodeCache, prompts=None) -> torch.Tensor:
        """The greedy loop over a prepared cache -> tokens [B, total].
        `prompts` [B, P] gives each row its own prompt (default: the
        evaluator's)."""
        prompts = self._prompt if prompts is None else prompts
        return greedy_decode_from_cache(self.params, cache, self.cfg, prompts,
                                        lora=self.lora,
                                        lora_scale=self.lora_scale,
                                        scores_int8=self.scores_int8,
                                        kernels=self.kernels)

    def beam(self, mel: torch.Tensor, prompts=None) -> torch.Tensor:
        """Encoder + beam search of `num_beams` -> the best beam's tokens
        [B, total]."""
        prompts = self._prompt if prompts is None else prompts
        return beam_decode(self.params, self.encode(mel), self.cfg, prompts,
                           num_beams=self.num_beams,
                           max_new_tokens=self.max_new_tokens, lora=self.lora,
                           lora_scale=self.lora_scale,
                           cross_kv_int8=self.kv_int8, self_kv_int8=self.kv_int8,
                           cross_kv_int4=self.kv_int4, self_kv_int4=self.kv_int4,
                           scores_int8=self.scores_int8, kernels=self.kernels)

    def tokens(self, mel: torch.Tensor, prompts=None) -> torch.Tensor:
        """One batch's tokens [B, total]: beam search when num_beams > 1,
        else prep + dec."""
        if self.num_beams > 1:
            return self.beam(mel, prompts)
        return self.dec(self.prep(mel), prompts)

    def _transcribe_batch(self, mel: torch.Tensor) -> list:
        ids = transcribe_tokens(self.tokens(mel), self.cfg,
                                prompt_len=int(self._prompt.shape[0]))
        if self.tokenizer is None:
            return ids
        return [self.tokenizer.decode(row) for row in ids]

    def from_audio(self, audio) -> list:
        """Raw 16 kHz audio ([B, N] array/tensor, or a list of 1-D
        waveforms) -> per-clip token ids (or text): pad/trim to the 30 s
        window, log-mel on the device in the params' dtype, keep the
        encoder's `num_audio_frames` frames, then decode."""
        if isinstance(audio, (list, tuple)):
            audio = mel_ops.stack_pad_audio(audio)
        if not isinstance(audio, torch.Tensor):
            audio = torch.from_numpy(np.asarray(audio, np.float32))
        audio = audio.to(self.device, torch.float32)
        feats = mel_ops.log_mel_spectrogram(
            mel_ops.pad_or_trim(audio), self.cfg.num_mel_bins, dtype=self.dtype)
        return self._transcribe_batch(feats[:, :, :self.cfg.num_audio_frames])

    def evaluate(self, dataloader, return_predictions: bool = False) -> dict:
        """Corpus WER/CER (and the sample count) over one epoch of a
        dataloader whose batches carry "input_features" and "texts"."""
        if self.tokenizer is None:
            raise ValueError("evaluate compares text: give the evaluator a tokenizer")
        preds, refs = [], []
        for batch in dataloader.one_epoch():
            feats = torch.as_tensor(batch["input_features"])
            preds.extend(self._transcribe_batch(feats.to(self.device, self.dtype)))
            refs.extend(batch["texts"])
        results = compute_metrics(preds, refs)
        results["num_samples"] = len(refs)
        logger.info("eval: WER=%.4f CER=%.4f n=%d", results["wer"],
                    results["cer"], results["num_samples"])
        if return_predictions:
            results["predictions"] = preds
            results["references"] = refs
        return results

    def evaluate_per_sample(self, dataloader) -> list[dict]:
        """Per-sample WER/CER rows with each prediction and reference."""
        out = self.evaluate(dataloader, return_predictions=True)
        per = compute_metrics_per_sample(out["predictions"], out["references"])
        for row, p, r in zip(per, out["predictions"], out["references"]):
            row["prediction"], row["reference"] = p, r
        return per

    def analyze(self, dataloader, top_k: int = 10) -> dict:
        """Corpus metrics plus the insertion/deletion analysis."""
        out = self.evaluate(dataloader, return_predictions=True)
        out["error_analysis"] = analyze_errors(out["predictions"],
                                               out["references"], top_k)
        return out

    def save_results(self, results: dict, output_dir: str | Path) -> None:
        """metrics.json, and predictions.txt / references.txt when the
        results hold them."""
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        metrics = {k: v for k, v in results.items()
                   if k not in ("predictions", "references")}
        (out / "metrics.json").write_text(json.dumps(metrics, indent=2))
        if "predictions" in results:
            (out / "predictions.txt").write_text(
                "\n".join(results["predictions"]) + "\n")
            (out / "references.txt").write_text(
                "\n".join(results["references"]) + "\n")


def transcribe_audio(audio: np.ndarray, cfg: WhisperConfig, params: dict,
                     tokenizer, language: str = "hindi",
                     max_new_tokens: int = 256, lora: dict | None = None,
                     lora_scale: float = 1.0, task: str = "transcribe",
                     device: torch.device | str | None = None) -> str:
    """One 16 kHz float32 waveform -> its transcription (greedy)."""
    return batch_transcribe([audio], cfg, params, tokenizer, language,
                            max_new_tokens=max_new_tokens, lora=lora,
                            lora_scale=lora_scale, task=task, device=device)[0]


def batch_transcribe(audios: list[np.ndarray], cfg: WhisperConfig,
                     params: dict, tokenizer, language: str = "hindi",
                     batch_size: int = 8, max_new_tokens: int = 256,
                     lora: dict | None = None, lora_scale: float = 1.0,
                     task: str = "transcribe", return_ids: bool = False,
                     device: torch.device | str | None = None
                     ) -> list[str] | list[list[int]]:
    """Raw-audio transcription in batches of `batch_size` (the last one
    padded with silent clips, so every batch has one shape): pad/trim to
    the 30 s window, mel on the device, greedy int8-KV decode. `return_ids`
    gives the per-clip token id lists instead of text."""
    ev = ASREvaluator(cfg, params, None if return_ids else tokenizer,
                      language=language, max_new_tokens=max_new_tokens,
                      lora=lora, lora_scale=lora_scale, task=task, device=device)
    out: list = []
    for s in range(0, len(audios), batch_size):
        chunk = list(audios[s:s + batch_size])
        n = len(chunk)
        out.extend(ev.from_audio(chunk + [np.zeros(1, np.float32)]
                                 * (batch_size - n))[:n])
    return out
