"""Temperature-fallback transcription (counterpart of
sar_tpu/evaluation/fallback.py; openai-whisper's robust decode).

Each window decodes greedily first and is decoded again at rising
sampling temperatures while the result looks degenerate:

  - compression_ratio > compression_ratio_threshold (2.4): text so
    repetitive that zlib crushes it;
  - avg_logprob < logprob_threshold (-1.0): the model was guessing;

unless p(<|nospeech|>) says the window is silence, which never retries
(`should_skip_silence` drops such windows in long-form instead).

`FallbackTranscriber` runs the encoder once per batch and, per pass, the
cache build through its DecodeRunner's `prep` (kernel K2, K4 with a
cross_v adapter, over the int8 head-minor cache) and the greedy loop
(kernel K3) with sampling, logprobs, no-speech and the generation cap on.
The runner replays one captured program for every pass: the temperature,
the seed, the prompt length and the no-speech position are refilled per
call (decode/graphs.py), so the ladder, `best_of` candidates and every
window of a conditioned long-form run share it. The per-call seeds fold
as JAX's keys do: (call, temperature index, candidate), through
`whisper.fold_in`.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from sar_tpu_torch.decode.graphs import (CudaGraphCapture, DecodeRunner,
                                         resolve_capture)
from sar_tpu_torch.decode.greedy import transcribe_tokens
from sar_tpu_torch.device import resolve_device, tree_to
from sar_tpu_torch.models import whisper

DEFAULT_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


def compression_ratio(text: str) -> float:
    """openai-whisper's definition: utf-8 length / zlib-compressed length."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def needs_retry(text: str, avg_logprob: float, *,
                compression_ratio_threshold: float | None = 2.4,
                logprob_threshold: float | None = -1.0,
                no_speech_prob: float | None = None,
                no_speech_threshold: float | None = None) -> bool:
    """openai transcribe.py's needs_fallback (thresholds None = off):
    repetitive or unconfident text retries, unless the window is probably
    silence (no_speech_prob above its threshold)."""
    retry = False
    if (compression_ratio_threshold is not None
            and compression_ratio(text) > compression_ratio_threshold):
        retry = True
    if logprob_threshold is not None and avg_logprob < logprob_threshold:
        retry = True
    if (no_speech_threshold is not None and no_speech_prob is not None
            and no_speech_prob > no_speech_threshold):
        retry = False
    return retry


def should_skip_silence(row: dict, *,
                        no_speech_threshold: float | None = 0.6,
                        logprob_threshold: float | None = -1.0) -> bool:
    """openai transcribe.py's segment-skip rule: the window is silence when
    p(<|nospeech|>) exceeds the threshold, unless the text is confident
    enough (avg_logprob > logprob_threshold) to overrule it."""
    if no_speech_threshold is None:
        return False
    skip = row.get("no_speech_prob", 0.0) > no_speech_threshold
    if (logprob_threshold is not None
            and row.get("avg_logprob", 0.0) > logprob_threshold):
        skip = False
    return skip


class FallbackTranscriber:
    """The fallback decoder of one set of parameters, reused across calls
    (long-form groups, evaluator batches): its DecodeRunner keeps the
    static cache and the captured program.

    `lora` is a bank whose adapter 0 adapts every row, with `lora_scale`;
    `kv_int8` picks the int8 head-minor cache (the default, K2/K3) or the
    unquantized classic one; `flash` goes to `encode` ("auto": "hm", K1,
    on the card). `prompt_tokens` replaces the standard prompt;
    `prompt_width` reserves room for wider per-call prompts (conditioned
    long-form). `best_of` candidates per sampled pass, the best average
    logprob winning per row. Runs on the card unless `device` says
    otherwise; `capture` and `kernels` as ASREvaluator takes them."""

    def __init__(self, cfg, params, tokenizer, *, language: str = "hindi",
                 max_new_tokens: int = 256,
                 temperatures=DEFAULT_TEMPERATURES,
                 compression_ratio_threshold: float | None = 2.4,
                 logprob_threshold: float | None = -1.0,
                 no_speech_threshold: float | None = 0.6,
                 lora=None, lora_scale: float = 1.0,
                 kv_int8: bool = True, flash: str | bool = "auto",
                 seed: int = 0, prompt_tokens=None,
                 timestamps: bool = False, prompt_width: int | None = None,
                 task: str = "transcribe", best_of: int = 1,
                 device: torch.device | str | None = None,
                 kernels: bool = True, capture: bool | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        dtype = self.params["decoder"]["token_embed"].dtype
        self.lora = tree_to(lora, self.device, dtype) if lora is not None else None
        self.lora_scale = lora_scale
        self.tokenizer = tokenizer
        self.temperatures = tuple(temperatures)
        self.max_new_tokens = max_new_tokens
        self.best_of = max(1, int(best_of))
        self.compression_ratio_threshold = compression_ratio_threshold
        self.logprob_threshold = logprob_threshold
        self.no_speech_threshold = no_speech_threshold
        self.seed = seed
        self._calls = 0
        self.flash = whisper.resolve_flash(flash, self.device)
        self.kernels = kernels
        # timestamps=True decodes under the timestamp grammar; the
        # thresholds judge the timestamp-stripped text.
        self.timestamps = timestamps
        self._prompt = (list(prompt_tokens) if prompt_tokens is not None
                        else cfg.prompt_ids(language, task,
                                            no_timestamps=not timestamps))
        width = max(len(self._prompt), prompt_width or 0)
        self.total = min(width + max_new_tokens, cfg.max_target_positions)
        self._flags = dict(cross_kv_int8=kv_int8, self_kv_int8=kv_int8)
        self.runner = DecodeRunner(
            self.params, cfg, lora=self.lora, lora_scale=lora_scale,
            kernels=kernels,
            capture=(CudaGraphCapture if resolve_capture(capture, self.device, kernels)
                     else None))

    @torch.no_grad()
    def encode(self, mel) -> torch.Tensor:
        return whisper.encode(self.params, torch.as_tensor(mel).to(self.device),
                              self.cfg, lora=self.lora, lora_scale=self.lora_scale,
                              flash=self.flash, kernels=self.kernels)

    def __call__(self, mel, n_valid: int | None = None, prompt=None,
                 prompt_len: int | None = None):
        """(texts, info) of a mel batch [B, n_mels, frames]: per row the
        accepted text and {"temperature", "avg_logprob", "no_speech_prob",
        "compression_ratio", "ids"}. `prompt` (an id buffer [P] or [1, P]
        within the prompt_width budget) and `prompt_len` (its forced
        length) override the constructor's prompt for this call. Rows at
        or above `n_valid` are batch padding: they decode but never
        escalate."""
        cfg = self.cfg
        enc_out = self.encode(mel)
        B = enc_out.shape[0]
        texts: list[str | None] = [None] * B
        info: list[dict | None] = [None] * B
        pending = list(range(B if n_valid is None else min(n_valid, B)))
        prompt = torch.as_tensor(self._prompt if prompt is None else prompt,
                                 dtype=torch.int64)
        P_std = len(self._prompt)
        P = int(prompt.shape[-1]) if prompt_len is None else int(prompt_len)
        # A fresh seed per call, so that windows and batches resample
        # independently.
        self._calls += 1
        call_seed = whisper.fold_in(self.seed, self._calls)
        for t_idx, temperature in enumerate(self.temperatures):
            n_cand = 1 if temperature == 0.0 else self.best_of
            base_seed = whisper.fold_in(call_seed, t_idx)
            ids = sum_lp = n_sc = ns_prob = None
            for c in range(n_cand):
                cache = self.runner.prep(enc_out, self.total, **self._flags)
                tokens, c_slp, c_nsc, c_nsp = self.runner.greedy(
                    cache, prompt, prompt_len=P, temperature=float(temperature),
                    seed=base_seed if c == 0 else whisper.fold_in(base_seed, c),
                    with_logprobs=True, with_no_speech=True,
                    timestamps=self.timestamps, no_speech_pos=P - P_std,
                    max_gen_tokens=self.max_new_tokens)
                c_ids = transcribe_tokens(tokens, cfg, prompt_len=P)
                c_slp, c_nsc, c_nsp = (x.cpu().numpy() for x in (c_slp, c_nsc, c_nsp))
                if ids is None:
                    ids = list(c_ids)
                    sum_lp, n_sc, ns_prob = c_slp.copy(), c_nsc.copy(), c_nsp.copy()
                else:
                    better = (c_slp / np.maximum(c_nsc, 1)
                              > sum_lp / np.maximum(n_sc, 1))
                    for b in np.flatnonzero(better):
                        ids[b] = c_ids[b]
                        sum_lp[b], n_sc[b] = c_slp[b], c_nsc[b]
                        ns_prob[b] = c_nsp[b]
            still = []
            for b in pending:
                row_ids = ids[b][:self.max_new_tokens]
                text_ids = ([i for i in row_ids if i < cfg.no_timestamps_token_id]
                            if self.timestamps else row_ids)
                text = self.tokenizer.decode(text_ids)
                avg_lp = float(sum_lp[b] / max(int(n_sc[b]), 1))
                row = {"temperature": float(temperature),
                       "avg_logprob": avg_lp,
                       "no_speech_prob": float(ns_prob[b]),
                       "compression_ratio": compression_ratio(text),
                       # The accepted ids (prompt and EOS stripped, timestamp
                       # tokens kept): the aligner and the segment splitter
                       # read them.
                       "ids": list(row_ids)}
                texts[b], info[b] = text, row
                last = t_idx == len(self.temperatures) - 1
                if not last and needs_retry(
                        text, avg_lp,
                        compression_ratio_threshold=self.compression_ratio_threshold,
                        logprob_threshold=self.logprob_threshold,
                        no_speech_prob=row["no_speech_prob"],
                        no_speech_threshold=self.no_speech_threshold):
                    still.append(b)
            pending = still
            if not pending:
                break
        return texts, info


def transcribe_batch_with_fallback(cfg, params, mel, tokenizer, *,
                                   n_valid: int | None = None, **kw):
    """One-shot FallbackTranscriber: (texts, info) of a mel batch [B,
    n_mels, frames]; rows that fail every temperature keep the last
    (highest-T) result, as openai's transcribe; rows >= `n_valid` never
    escalate."""
    return FallbackTranscriber(cfg, params, tokenizer, **kw)(mel, n_valid)
