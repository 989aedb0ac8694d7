"""Streaming (incremental) transcription over a growing audio stream
(counterpart of sar_tpu/evaluation/streaming.py).

Whisper's encoder is bidirectional over a fixed window, so frames cannot
be encoded one at a time; the streaming recipe (LocalAgreement, as in
whisper_streaming) re-runs the window on every audio update and COMMITS
the longest common prefix of consecutive hypotheses: committed text is
stable, the tail may still be revised.

Every update runs the same two programs, as the JAX transcriber's two
jits: `prep` (the window zero-padded to the model's window, the
config's frontend on the device in the weights' dtype (models/frontend.py:
an ESPnet config's window is 30 s), `encode`, the cache built into the
runner's static cache) and `dec` (the greedy loop over a token buffer of
the whole width, the prompt then the committed ids, with the forced
prefix length `prompt_len` = prompt + committed refilled per call). The
committed transcript is forced through the loop (which rebuilds the self
cache for the new encoder output) and generation continues from there.
The loop is a `DecodeRunner`'s (decode/graphs.py): one key for every
update and every rollover, each segment captured once on the card and
replayed after. Streams longer than one window roll over: when the
buffer fills, the window's final hypothesis is committed wholesale and a
fresh window begins.

`kv_int8` (JAX's default False: the unquantized classic cache, plain
torch) builds the int8 head-minor cache (kernels K2 and K3); `flash`
goes to `encode` ("auto" is "hm", kernel K1, on the card and exact
attention on the CPU). The transcriber runs on the CUDA card unless
`device` says otherwise; `kernels` and `capture` are the evaluator's.
"""

from __future__ import annotations

import numpy as np
import torch

from sar_tpu_torch.decode.graphs import CudaGraphCapture, DecodeRunner, resolve_capture
from sar_tpu_torch.decode.greedy import transcribe_tokens
from sar_tpu_torch.device import resolve_device, tree_to
from sar_tpu_torch.models import frontend, whisper
from sar_tpu_torch.models.config import WhisperConfig


def common_prefix_len(a: list[int], b: list[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class StreamingTranscriber:
    """Incremental transcriber for one audio stream.

    ``feed(chunk)`` appends 16 kHz float32 samples and returns the text
    committed so far; ``finalize()`` flushes the tail and returns the full
    transcript. ``hypothesis`` exposes the unstable tail for display.
    `lora` is a bank whose adapter 0 adapts the encoder, the cache and
    the decode.
    """

    def __init__(self, cfg: WhisperConfig, params: dict, tokenizer,
                 language: str = "hindi", max_new_tokens: int = 224,
                 lora: dict | None = None, lora_scale: float = 1.0,
                 kv_int8: bool = False, flash: str | bool = "auto",
                 task: str = "transcribe",
                 device: torch.device | str | None = None,
                 kernels: bool = True, capture: bool | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.dtype = self.params["decoder"]["token_embed"].dtype
        self.lora = (tree_to(lora, self.device, self.dtype)
                     if lora is not None else None)
        self.lora_scale = lora_scale
        self.tokenizer = tokenizer
        self.kernels = kernels
        self.window_samples = frontend.window_samples(cfg)
        prompt = cfg.prompt_ids(language, task)
        self._p0 = len(prompt)
        self._total = min(self._p0 + max_new_tokens, cfg.max_target_positions)
        self._prompt = np.asarray(prompt, np.int64)
        self.flash = whisper.resolve_flash(flash, self.device)
        self._flags = dict(cross_kv_int8=kv_int8, self_kv_int8=kv_int8,
                           head_minor=whisper.use_head_minor(
                               cross_kv_int8=kv_int8, self_kv_int8=kv_int8))
        self.capture = resolve_capture(capture, self.device, kernels)
        self.runner = DecodeRunner(self.params, cfg, lora=self.lora,
                                   lora_scale=lora_scale, kernels=kernels,
                                   capture=CudaGraphCapture if self.capture else None)
        self.reset()

    def reset(self) -> None:
        self._audio = np.zeros(0, np.float32)
        self._committed: list[int] = []     # generated ids, current window
        self._last_hyp: list[int] | None = None
        self._segments: list[str] = []      # rolled-over windows' text

    @property
    def _commit_cap(self) -> int:
        """Committed ids never exceed capacity-1, so the forced prefix always
        covers the WHOLE committed transcript (a truncated forced prefix
        could be re-generated differently and retract committed text)."""
        return self._total - self._p0 - 1

    # -- internals -----------------------------------------------------
    def _features(self, audio: np.ndarray) -> torch.Tensor:
        """The window's features [1, n_mels, frames]: the clip padded to
        the window, through the config's frontend in the weights' dtype."""
        return frontend.features([audio], self.cfg, self.params, dtype=self.dtype,
                                 device=self.device, samples=self.window_samples)

    @torch.no_grad()
    def _prep(self, audio: np.ndarray) -> whisper.DecodeCache:
        """features -> encode -> the cache, into the runner's static cache."""
        enc = whisper.encode(self.params, self._features(audio), self.cfg,
                             lora=self.lora, lora_scale=self.lora_scale, flash=self.flash,
                             kernels=self.kernels)
        return self.runner.prep(enc, self._total, **self._flags)

    def _decode_window(self, audio: np.ndarray) -> list[int]:
        """One update: returns the window's generated ids (the forced
        committed prefix followed by fresh greedy continuation)."""
        # feed() keeps _committed <= cap; the slice only guards the
        # feed-after-finalize() edge (finalize commits the full hypothesis).
        committed = self._committed[:self._commit_cap]
        buf = np.full((1, self._total), self.cfg.eos_token_id, np.int64)
        buf[0, :self._p0] = self._prompt
        buf[0, self._p0:self._p0 + len(committed)] = committed
        tokens = self.runner.greedy(self._prep(audio), buf,
                                    prompt_len=self._p0 + len(committed))
        return transcribe_tokens(tokens, self.cfg, prompt_len=self._p0)[0]

    def _rollover(self) -> None:
        """Window full: commit its final hypothesis and start a new one."""
        hyp = self._decode_window(self._audio[:self.window_samples])
        text = self.tokenizer.decode(hyp).strip()
        if text:
            self._segments.append(text)
        self._audio = self._audio[self.window_samples:]
        self._committed, self._last_hyp = [], None

    # -- public --------------------------------------------------------
    def feed(self, chunk: np.ndarray) -> str:
        """Append audio, run one update, return the committed text."""
        self._audio = np.concatenate(
            [self._audio, np.asarray(chunk, np.float32).reshape(-1)])
        while len(self._audio) > self.window_samples:
            self._rollover()
        hyp = self._decode_window(self._audio)
        if self._last_hyp is not None:
            # LocalAgreement-2: commit what two consecutive hypotheses
            # agree on. Both start with the (fully) forced committed
            # prefix, so the committed text never shrinks; the cap keeps
            # the NEXT forced prefix full-coverage too.
            agree = common_prefix_len(self._last_hyp, hyp)
            self._committed = hyp[:min(agree, self._commit_cap)]
        self._last_hyp = hyp
        return self.text

    def finalize(self) -> str:
        """Flush: the current window's final hypothesis is committed."""
        if self._last_hyp is None:
            if len(self._audio) == 0:
                return self.text      # nothing fed: don't decode silence
            self._last_hyp = self._decode_window(self._audio)
        self._committed = self._last_hyp
        return self.text

    @property
    def text(self) -> str:
        """Committed (stable) transcript."""
        parts = self._segments + [self.tokenizer.decode(self._committed)]
        return " ".join(p.strip() for p in parts if p.strip())

    @property
    def hypothesis(self) -> str:
        """Committed transcript + the unstable tail of the last update."""
        if self._last_hyp is None:
            return self.text
        parts = self._segments + [self.tokenizer.decode(self._last_hyp)]
        return " ".join(p.strip() for p in parts if p.strip())
