"""Batched transcription and corpus WER/CER (counterpart of
sar_tpu/evaluation/evaluator.py::ASREvaluator, int8-KV or int4-KV greedy
and beam decoding, with or without one LoRA adapter).

Greedy runs two phases per batch, as in the reference: `prep` (encoder +
the int8 head-minor cross-KV cache, the int4 classic one, or with
kv_int8=False the unquantized classic one in plain torch) and `dec`
(the greedy loop over that cache). Beam search (`num_beams` > 1) runs the
encoder, a cache with one cross slab per sample and B*K self-cache rows,
and the beam loop. Both pass the cache flags (`kv_int8`, `kv_int4`) to
the decode explicitly, as the JAX evaluator does: the decode functions'
own default is the unquantized cache.

The evaluator holds its decode programs as the JAX evaluator holds its
`jax.jit` programs: a `DecodeRunner` (decode/graphs.py) owns the static
cache that `prep` writes (JAX donates it into `_decode`) and replays each
segment of the greedy or beam loop as a CUDA graph captured at the first
batch of its shape. `capture` chooses: None (the default) captures on a
CUDA device and runs eagerly on the CPU, True on the CPU raises, False
runs the loop eagerly (the yardstick); `kernels=False` runs eagerly. The
prep stays eager.
`flash` goes to `encode` as in the JAX evaluator: "hm" (kernel K1), "fq"
(kernel K8, which `encode` turns into "hm" when an adapter holds q/k/v),
False or True; "auto" is "hm" on the card. `evaluate` transcribes a
dataloader's split and returns corpus WER/CER; `evaluate_per_sample`,
`analyze` and `save_results` are the JAX evaluator's. The opt-in
quantized decode is the JAX evaluator's too: `scores_int8` (s8 scores
over the int8 cache, kernel K7) and `kv_int4` (the nibble-packed int4
cache, which supersedes kv_int8), with its checks
(`quantized_decode_options`). `fallback=True` transcribes each batch
through a FallbackTranscriber (evaluation/fallback.py: openai's
temperature ladder with `best_of` candidates per sampled pass), greedy
only, as the JAX evaluator: with beams it is turned off with a warning.

`mesh` (parallel/sharding.py, one process per rank) evaluates data and
tensor parallel, as the JAX evaluator's mesh path: the weights are this
rank's shard, a partial batch is padded to the batch shards, each rank
decodes its rows over a classic cache (`use_head_minor(mesh=)` is
False: no K2/K3, as no decode kernel of the JAX package has an SPMD
rule) and the texts are gathered, so `evaluate` returns the same metrics
on every rank. The encoder keeps its `flash` setting (K1 on the card, on
the rank's heads). `scores_int8` and `fallback` are turned off with the
JAX evaluator's warnings. The decode is captured where the "model" group
has one rank; with more it runs eagerly (`DecodeRunner(tp=)`).

`transcribe_audio` and `batch_transcribe` compute what the JAX package's
do: exact encoder attention (flash=False) and greedy over the unquantized
classic cache, through an ASREvaluator(kv_int8=False, flash=False) whose
runner replays its captured loop on the card. As JAX's module-level
`_transcribe_step` compiles once for every call of one shape, that
evaluator is kept at module level (`plain_evaluator`): calls with the same
weights (the same tensors), adapter, scale, prompt width and token budget
replay the program the first one captured, whatever their language or
task (the prompt is refilled per call). At most one is kept: other
weights or settings drop it, its cache and its graphs first.

While a profiler is active, `from_audio`'s frontend (stacking, padding,
the copy and log-mel), `encode` and detokenization are spans
(utils/profiling.py), beside the runner's `prep` and `decode`.

The evaluator runs on the CUDA card unless `device` says otherwise (see
sar_tpu_torch/device.py); params and the adapter on another device are
moved to its device once, here. Results are text when a tokenizer is
given, else token-id lists.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path

import numpy as np
import torch

from sar_tpu_torch.decode.graphs import (CudaGraphCapture, DecodeRunner,
                                         resolve_capture)
from sar_tpu_torch.decode.greedy import transcribe_tokens
from sar_tpu_torch.device import resolve_device, tree_to
from sar_tpu_torch.evaluation.fallback import FallbackTranscriber
from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import WhisperConfig
from sar_tpu_torch.ops import mel as mel_ops
from sar_tpu_torch.parallel import distributed as pdist
from sar_tpu_torch.parallel import sharding
from sar_tpu_torch.training.metrics import (analyze_errors, compute_metrics,
                                            compute_metrics_per_sample)
from sar_tpu_torch.utils import profiling

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
    """Greedy or beam transcription of whole batches on one device, over
    the int8 KV cache (the default), the int4 one or the unquantized one
    (kv_int8=False).

    `lora` is a bank whose adapter 0 adapts every row (a single adapter, as
    the JAX evaluator takes it), with `lora_scale` = alpha / r; its cross_v
    term rides kernel K4 in its broadcast form. `capture` as in the module
    docstring."""

    def __init__(self, cfg: WhisperConfig, params: dict, tokenizer=None,
                 language: str = "hindi", max_new_tokens: int = 256,
                 num_beams: int = 1, lora: dict | None = None,
                 lora_scale: float = 1.0,
                 kv_int8: bool = True, mesh=None,
                 flash: str | bool = "auto", scores_int8: bool = False,
                 prompt_tokens=None, fallback: bool = False,
                 best_of: int = 1,
                 task: str = "transcribe", kv_int4: bool = False,
                 device: torch.device | str | None = None,
                 kernels: bool = True, capture: bool | None = None):
        if num_beams < 1:
            raise ValueError(f"num_beams must be >= 1, got {num_beams}")
        self.kv_int8, self.kv_int4 = quantized_decode_options(
            kv_int8, kv_int4, scores_int8)
        if scores_int8 and num_beams > 1:
            logger.info("beams + scores_int8 fold each sample's beams into "
                        "one s8 cross-attention call (K7) and reorder the "
                        "self cache physically each step")
        if scores_int8 and mesh is not None:
            logger.warning("scores_int8 is unsupported under a device mesh; "
                           "falling back to bf16 attention scores")
            scores_int8 = False
        self.scores_int8 = scores_int8
        self.cfg = cfg
        self.mesh = mesh
        self.tp = sharding.model_group(mesh)
        self.device = (resolve_device(device) if mesh is None
                       else sharding.mesh_device(mesh))
        self.params = tree_to(params, self.device)
        if mesh is not None:
            self.params = sharding.shard_params(self.params, mesh, cfg)
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
        if self.tp is not None and capture:
            raise ValueError("capture=True under a mesh whose model axis has "
                             f"{self.tp.size} ranks: its decode runs eagerly")
        self.capture = (resolve_capture(capture, self.device, kernels)
                        and self.tp is None)
        self._flags = dict(cross_kv_int8=self.kv_int8, self_kv_int8=self.kv_int8,
                           cross_kv_int4=self.kv_int4, self_kv_int4=self.kv_int4)
        if mesh is not None:
            self._flags["head_minor"] = whisper.use_head_minor(**self._flags, mesh=mesh)
        self.runner = DecodeRunner(self.params, cfg, lora=self.lora,
                                   lora_scale=lora_scale, kernels=kernels,
                                   capture=CudaGraphCapture if self.capture else None,
                                   tp=self.tp)
        # openai-style temperature fallback: greedy single-chip only, as in
        # the JAX evaluator (the escalation re-decode has no beam or mesh
        # path).
        if fallback and (num_beams > 1 or mesh is not None):
            logger.warning("fallback applies to greedy single-chip "
                           "evaluation; disabled here")
            fallback = False
        self.fallback, self.best_of = fallback, best_of
        self._fallback = None
        if fallback:
            if tokenizer is None:
                raise ValueError("fallback judges text: give the evaluator a tokenizer")
            self._fallback = FallbackTranscriber(
                cfg, self.params, tokenizer, language=language,
                max_new_tokens=max_new_tokens, lora=self.lora,
                lora_scale=lora_scale, kv_int8=self.kv_int8, flash=self.flash,
                best_of=best_of, prompt_tokens=prompt, device=self.device,
                kernels=kernels, capture=self.capture)

    @torch.no_grad()
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """The (adapted) encoder over a batch of log-mel features."""
        with profiling.span("encode"):
            return whisper.encode(self.params, mel.to(self.device), self.cfg,
                                  lora=self.lora, lora_scale=self.lora_scale,
                                  flash=self.flash, tp=self.tp)

    @torch.no_grad()
    def prep(self, mel: torch.Tensor) -> whisper.DecodeCache:
        """Encoder + cross-KV projection/quantization for one batch, into
        the runner's static cache (the cache of the previous batch)."""
        return self.runner.prep(self.encode(mel), self.total, **self._flags)

    def dec(self, cache: whisper.DecodeCache, prompts=None) -> torch.Tensor:
        """The greedy loop over the cache `prep` returned -> tokens
        [B, total]. `prompts` [B, P] gives each row its own prompt
        (default: the evaluator's)."""
        prompts = self._prompt if prompts is None else prompts
        return self.runner.greedy(cache, prompts, scores_int8=self.scores_int8)

    def beam(self, mel: torch.Tensor, prompts=None) -> torch.Tensor:
        """Encoder + cache (one cross slab per sample) + beam search of
        `num_beams` -> the best beam's tokens [B, total]."""
        prompts = self._prompt if prompts is None else prompts
        enc = self.encode(mel)
        cache = self.runner.prep(enc, self.total,
                                 self_batch=enc.shape[0] * self.num_beams,
                                 **self._flags)
        return self.runner.beam(cache, prompts, num_beams=self.num_beams,
                                scores_int8=self.scores_int8)

    def tokens(self, mel: torch.Tensor, prompts=None) -> torch.Tensor:
        """One batch's tokens [B, total]: beam search when num_beams > 1,
        else prep + dec."""
        if self.num_beams > 1:
            return self.beam(mel, prompts)
        return self.dec(self.prep(mel), prompts)

    def _transcribe_batch(self, mel: torch.Tensor, prompts=None) -> list:
        if self._fallback is not None:
            return self._fallback(mel)[0]
        B = mel.shape[0]
        if self.mesh is not None:
            # This rank's rows of the batch padded to the batch shards.
            mel = pdist.pad_global_batch(mel, self.mesh)
            pad = mel.shape[0] - B
            mel = pdist.put_global_batch(mel, self.mesh, device=self.device)
            if prompts is not None and torch.as_tensor(prompts).dim() == 2:
                prompts = torch.as_tensor(prompts)
                prompts = pdist.put_global_batch(
                    torch.cat([prompts, prompts[-1:].expand(pad, -1)]), self.mesh,
                    device=self.device)
        tokens = self.tokens(mel, prompts)
        with profiling.span("detokenize"):
            ids = transcribe_tokens(tokens, self.cfg,
                                    prompt_len=int(self._prompt.shape[0]))
        if self.mesh is not None:
            ids = sharding.batch_gather_objects(ids, self.mesh)[:B]
        if self.tokenizer is None:
            return ids
        return [self.tokenizer.decode(row) for row in ids]

    def from_audio(self, audio, prompts=None) -> list:
        """Raw 16 kHz audio ([B, N] array/tensor, or a list of 1-D
        waveforms) -> per-clip token ids (or text): pad/trim to the 30 s
        window, log-mel on the device in the params' dtype, keep the
        encoder's `num_audio_frames` frames, then decode (with `prompts`
        [P] or [B, P] of the evaluator's prompt width, when given)."""
        with profiling.span("frontend"):
            if isinstance(audio, (list, tuple)):
                audio = mel_ops.stack_pad_audio(audio)
            if not isinstance(audio, torch.Tensor):
                audio = torch.from_numpy(np.asarray(audio, np.float32))
            audio = audio.to(self.device, torch.float32)
            feats = mel_ops.log_mel_spectrogram(
                mel_ops.pad_or_trim(audio), self.cfg.num_mel_bins, dtype=self.dtype)
        return self._transcribe_batch(feats[:, :, :self.cfg.num_audio_frames], prompts)

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
        results hold them; under a mesh rank 0 alone writes (every rank
        holds the same results)."""
        if not pdist.is_main_process():
            return
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


# The plain evaluator of batch_transcribe: at most one (settings, weight
# tensors, their version counters, evaluator). The lock serialises the
# calls that share it: its runner's static buffers serve one decode at a
# time.
_PLAIN: list = []
_PLAIN_LOCK = threading.RLock()


def _version(t) -> int | None:
    """A tensor's in-place version counter; None for an inference tensor,
    which keeps none, and for a leaf that is not a tensor."""
    return (t._version if isinstance(t, torch.Tensor) and not t.is_inference()
            else None)


def plain_evaluator(cfg: WhisperConfig, params: dict, prompt: list[int],
                    max_new_tokens: int = 256, lora: dict | None = None,
                    lora_scale: float = 1.0,
                    device: torch.device | str | None = None) -> ASREvaluator:
    """The ASREvaluator(kv_int8=False, flash=False) that batch_transcribe
    decodes with: the one kept from an earlier call when the weights are
    the same tensors (params and adapter, leaf by leaf, so a dict rebuilt
    around them still matches), each either decoded as it is or unchanged
    in place since (its version counter: the kept evaluator's device or
    dtype copy would be stale), and the settings are equal (the config,
    the prompt's width, `max_new_tokens`, `lora_scale`, the device); else a
    new one, built after the old one is dropped. Its tokenizer is None
    (token ids); `prompt` sets the prompt width its program is keyed on."""
    device = resolve_device(device)
    settings = (cfg, len(prompt), max_new_tokens, float(lora_scale), device)
    weights = whisper.tree_leaves({"params": params, "lora": lora})
    with _PLAIN_LOCK:
        if _PLAIN:
            kept_settings, kept, versions, ev = _PLAIN[0]
            used = whisper.tree_leaves({"params": ev.params, "lora": ev.lora})
            if kept_settings == settings and len(kept) == len(weights) and all(
                    w is k and (u is w or (v is not None and v == _version(w)))
                    for w, k, u, v in zip(weights, kept, used, versions)):
                return ev
        _PLAIN.clear()
        ev = ASREvaluator(cfg, params, None, max_new_tokens=max_new_tokens, lora=lora,
                          lora_scale=lora_scale, prompt_tokens=prompt, device=device,
                          kv_int8=False, flash=False)
        _PLAIN.append((settings, weights, [_version(w) for w in weights], ev))
        return ev


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
    the 30 s window, mel on the device in the weights' dtype, the encoder
    with exact attention and greedy over the unquantized classic cache (the
    JAX package's batch_transcribe: its encode and greedy_decode
    defaults), through `plain_evaluator`: a later call of the same key
    replays the captured program. `return_ids` gives the per-clip token id
    lists instead of text."""
    prompt = cfg.prompt_ids(language, task)
    out: list = []
    with _PLAIN_LOCK:
        ev = plain_evaluator(cfg, params, prompt, max_new_tokens=max_new_tokens,
                             lora=lora, lora_scale=lora_scale, device=device)
        prompts = torch.tensor(prompt, dtype=torch.int64, device=ev.device)
        for s in range(0, len(audios), batch_size):
            chunk = list(audios[s:s + batch_size])
            n = len(chunk)
            out.extend(ev.from_audio(chunk + [np.zeros(1, np.float32)]
                                     * (batch_size - n), prompts)[:n])
    if return_ids:
        return out
    return [tokenizer.decode(row) for row in out]
