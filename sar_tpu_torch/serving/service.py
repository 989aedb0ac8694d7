"""Micro-batching transcription service (counterpart of
sar_tpu/serving/service.py, greedy).

Requests arrive one at a time from any number of threads; ONE worker
thread owns the device and coalesces queued requests into batches of
`batch_size` (pad rows are zero audio), so every request, alone or in a
burst, rides the same two programs:

- greedy: mel -> prep (encoder + int8 cross-KV cache, one optional
  adapter) -> the greedy loop with each row's own language prompt;
- beam (`num_beams` > 1, no router): mel -> the encoder -> beam search
  over a cache with one cross slab per utterance (kernel K5 folds each
  utterance's beams into one cross-attention call), each row's own prompt;
- routed (an `AdapterRouter` instead of a fixed language): mel -> LID at
  the classifier's tap layer -> the adapted encoder with each row's
  adapter -> the cache build (its cross_v term through kernel K4) -> the
  routed greedy loop with each row's language prompt.

The precision options are the evaluator's (`kv_int4`, `scores_int8`, with
its checks); every program passes its cache flags explicitly (the int8
head-minor cache unless `kv_int4`), since the decode functions' own
default is the unquantized cache. A routed service decodes over the int4
cache when asked, and turns `scores_int8` off with a warning, as the JAX
service does. `flash` goes to the evaluator and on to `encode` ("fq" is
kernel K8; a routed service takes the router's `flash`).

A batch that fails hands its error to every request in it, and
`stats()["errors"]` counts such batches. The worker runs under
`torch.inference_mode()` itself (grad mode is per thread). The greedy
service runs on the CUDA card unless `device` says otherwise; a routed one
runs on the router's device, with the router's `flash` and `kernels`.
Results are text when a tokenizer is given, else token-id lists. A
routed service decodes greedily: asking it for beams raises, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from sar_tpu_torch.decode.greedy import transcribe_tokens
from sar_tpu_torch.evaluation.evaluator import (ASREvaluator,
                                                quantized_decode_options)
from sar_tpu_torch.ops import mel as mel_ops

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class _Request:
    audio: np.ndarray
    language: str | None
    done: threading.Event
    t_submit: float
    text: Any = None
    detected: str | None = None
    error: BaseException | None = None

    def result(self, timeout: float | None = None):
        if not self.done.wait(timeout):
            raise TimeoutError("transcription timed out")
        if self.error is not None:
            raise self.error
        return self.text


class TranscriptionService:
    """Micro-batching front over the transcription pipeline.

    Thread-safe: `transcribe`/`submit` may be called from any number of
    threads; one worker thread owns the device. Use as a context manager
    or call `close()` to stop the worker (pending requests drain first).
    """

    def __init__(self, cfg=None, params=None, tokenizer=None, *,
                 language: str = "hindi", router=None,
                 batch_size: int = 8, max_wait_ms: float = 10.0,
                 max_new_tokens: int = 256, num_beams: int = 1,
                 lora: dict | None = None, lora_scale: float = 1.0,
                 kv_int8: bool = True, flash: str | bool = "auto",
                 max_queue: int = 512, task: str = "transcribe",
                 kv_int4: bool = False, scores_int8: bool = False,
                 device: torch.device | str | None = None):
        if router is None and (cfg is None or params is None):
            raise ValueError("need cfg+params, or a router")
        if router is not None and num_beams > 1:
            raise ValueError("routed serving decodes greedily "
                             "(no beam-routed program)")
        if not (kv_int8 or kv_int4):
            raise NotImplementedError(
                "sar_tpu_torch TranscriptionService decodes over the int8 or "
                "the int4 KV cache; kv_int8=False (a bf16 cache) is not yet "
                "ported")
        kv_int8, kv_int4 = quantized_decode_options(kv_int8, kv_int4,
                                                    scores_int8)
        if scores_int8 and router is not None:
            logger.warning("scores_int8 applies to the non-routed serving "
                           "programs; decoding with bf16 scores")
            scores_int8 = False
        self.kv_int4 = kv_int4
        if router is not None and task != "transcribe":
            raise ValueError("routed serving is transcription-only (the "
                             "router's adapters are transcription-trained)")
        self.router = router
        self.tokenizer = tokenizer
        self.language = language
        self.task = task
        self.batch_size = batch_size
        self.max_wait_ms = max_wait_ms
        self.max_new_tokens = max_new_tokens
        if router is not None:
            if lora is not None or device is not None:
                raise ValueError("a routed service takes its adapters and "
                                 "its device from the router")
            self.cfg = router.cfg
            self.device = router.device
            self._dtype = router.dtype
            self._prompt_len = router.prompt_len
        else:
            self.cfg = cfg
            # The greedy and beam programs are the evaluator's; it also
            # refuses the options the port has not got (meshes, ...).
            self._ev = ASREvaluator(
                cfg, params, language=language, max_new_tokens=max_new_tokens,
                num_beams=num_beams, lora=lora, lora_scale=lora_scale,
                kv_int8=kv_int8, flash=flash,
                scores_int8=scores_int8, task=task, kv_int4=kv_int4,
                device=device)
            self.device = self._ev.device
            self._dtype = self._ev.dtype
            self._prompt_len = len(cfg.prompt_ids(language, task))
        self._q: queue.Queue[_Request] = queue.Queue(max_queue)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "batches": 0, "errors": 0,
                       "rows_served": 0}
        self._latencies: list[float] = []       # rolling, under _lock
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="sar-serving-worker")
        self._worker.start()

    # -- public API ---------------------------------------------------------

    def submit(self, audio: np.ndarray, language: str | None = None,
               block: bool = True) -> _Request:
        """Enqueue; returns a handle with `.result(timeout)`. Raises
        queue.Full when the service is saturated and block=False.
        Invalid requests (unknown language, audio beyond the model window)
        are refused HERE with ValueError, so one bad request never fails
        the batch it would have joined."""
        if self._stop.is_set():
            raise RuntimeError("service is closed")
        audio = np.asarray(audio, np.float32)
        max_samples = self.cfg.num_audio_frames * mel_ops.HOP_LENGTH
        if len(audio) > max_samples:
            raise ValueError(
                f"audio is {len(audio) / mel_ops.SAMPLE_RATE:.1f} s; the "
                f"serving window is {max_samples / mel_ops.SAMPLE_RATE:.1f} s "
                "— chunk long clips client-side")
        if language is not None and self.router is None:
            self.cfg.prompt_ids(language)   # raises for unknown languages
        req = _Request(audio, language, threading.Event(), time.monotonic())
        self._q.put(req, block=block)
        with self._lock:
            self._stats["requests"] += 1
        return req

    def transcribe(self, audio: np.ndarray, language: str | None = None,
                   timeout: float | None = None):
        return self.submit(audio, language).result(timeout)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            out = dict(self._stats)
            lats = list(self._latencies)
        out["queue_depth"] = self._q.qsize()
        out["batch_size"] = self.batch_size
        if lats:
            lats.sort()
            out["latency_ms_p50"] = round(lats[len(lats) // 2] * 1e3, 2)
            out["latency_ms_p95"] = round(
                lats[min(len(lats) - 1, int(len(lats) * 0.95))] * 1e3, 2)
        return out

    def close(self, drain: bool = True) -> None:
        """Stop the worker. drain=True serves what is already queued;
        drain=False errors pending requests out at once."""
        if not drain:
            self._fail_pending()
        self._stop.set()
        self._worker.join(timeout=600.0)
        self._fail_pending()             # anything the worker left behind

    def _fail_pending(self) -> None:
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            req.error = RuntimeError("service closed")
            req.done.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker -------------------------------------------------------------

    def _loop(self):
        with torch.inference_mode():
            while True:
                try:
                    first = self._q.get(timeout=0.05)
                except queue.Empty:
                    if self._stop.is_set():
                        return
                    continue
                batch = [first]
                deadline = time.monotonic() + self.max_wait_ms / 1e3
                while len(batch) < self.batch_size:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    try:
                        batch.append(self._q.get(timeout=left))
                    except queue.Empty:
                        break
                self._process(batch)

    def _features(self, batch: list[_Request]) -> torch.Tensor:
        pad = self.batch_size - len(batch)
        audio = mel_ops.stack_pad_audio(
            [r.audio for r in batch] + [np.zeros(1, np.float32)] * pad)
        feats = mel_ops.log_mel_spectrogram(
            torch.from_numpy(audio).to(self.device), self.cfg.num_mel_bins,
            dtype=self._dtype)
        return feats[:, :, :self.cfg.num_audio_frames]

    def _run(self, batch: list[_Request]):
        """One batch -> (tokens [batch_size, total], detected languages)."""
        feats = self._features(batch)
        n = len(batch)
        if self.router is not None:
            idx, _ = self.router.route(feats)
            tokens = self.router.decode(self.router.encode(feats, idx), idx,
                                        self.max_new_tokens,
                                        kv_int4=self.kv_int4)
            return tokens, [self.router.languages[i] for i in idx[:n].tolist()]
        prompts = torch.tensor(
            [self.cfg.prompt_ids(r.language or self.language, self.task)
             for r in batch]
            + [self.cfg.prompt_ids(self.language, self.task)]
            * (self.batch_size - n), dtype=torch.int64, device=self.device)
        return self._ev.tokens(feats, prompts), [None] * n

    def _process(self, batch: list[_Request]) -> None:
        try:
            tokens, detected = self._run(batch)
            ids = transcribe_tokens(tokens[:len(batch)], self.cfg,
                                    prompt_len=self._prompt_len)
            now = time.monotonic()
            with self._lock:
                self._stats["batches"] += 1
                self._stats["rows_served"] += len(batch)
                for r in batch:
                    self._latencies.append(now - r.t_submit)
                del self._latencies[:-1000]
            for req, row, det in zip(batch, ids, detected):
                req.text = (self.tokenizer.decode(row)
                            if self.tokenizer is not None else row)
                req.detected = det
                req.done.set()
        except BaseException as e:      # noqa: BLE001 — fan the error out
            logger.exception("serving batch failed")
            with self._lock:
                self._stats["errors"] += 1
            for req in batch:
                req.error = e
                req.done.set()
