"""KV-cached greedy decoding (counterpart of sar_tpu/decode/greedy.py).

The JAX package runs the loop as one `lax.while_loop` per segment; here
each segment is a host loop over its positions with the same semantics:
the decoder prompt `<|sot|><|lang|><|task|><|notimestamps|>` is fed
through the loop (prompt positions force the next token instead of taking
the argmax), rows that emitted EOS keep emitting EOS, and the loop stops
early once every row has finished. Suppress-token masking is available
and off by default.

`segment` (default 32, JAX's) has JAX's meaning (decode/segments.py):
segment s runs positions [s * segment, min((s + 1) * segment, total - 1))
and its self-attention reads only the first hi_s = min((s + 1) * segment,
total) rows of the self cache (`decode_step(self_len=)`), which cuts the
device work of the early steps; `segment=0` is one segment of the whole
length. The host asks whether every row has finished once per segment
(one sync), not once per step: finished rows keep emitting EOS, so the
tokens are those of a per-step check, and only the steps run are rounded
up to a segment boundary. These module functions run each segment eagerly
(what JAX traces); the entry points replay each segment as a captured CUDA
graph through a `DecodeRunner` (decode/graphs.py), as JAX's wrap this loop
in `jax.jit`.

The cache is, as in the JAX package, the unquantized classic one by
default; the int8 head-minor one of serving (`cross_kv_int8=True,
self_kv_int8=True`, kernels K2 and K3), the classic int8 one (the same
flags with `head_minor=False`, plain torch), or the int4 classic one
(`cross_kv_int4=True, self_kv_int4=True`) on request; `scores_int8` takes
the decode steps over the int8 cache to s8 scores (kernel K7). Sampling,
timestamps and logprobs wait for later slices of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from sar_tpu_torch.decode import segments
from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import WhisperConfig


def greedy_decode(params: dict, enc_out: torch.Tensor, cfg: WhisperConfig,
                  prompt_ids, *, max_new_tokens: int = 256,
                  lora: dict | None = None, adapter_idx=None,
                  lora_scale: float = 1.0,
                  suppress_ids: tuple[int, ...] = (),
                  cross_kv_int8: bool = False, self_kv_int8: bool = False,
                  cross_kv_int4: bool = False, self_kv_int4: bool = False,
                  scores_int8: bool = False, head_minor: bool | None = None,
                  segment: int = 32, kernels: bool = True) -> torch.Tensor:
    """Greedy decode over a cache built from `enc_out`: the unquantized
    classic one (the default, the JAX package's), the int8 head-minor one
    with cross_kv_int8 = self_kv_int8 = True (serving's), or the int4
    classic one (the int4 flags supersede the int8 ones); the layout is
    `whisper.use_head_minor`'s unless `head_minor` says otherwise
    (head_minor=False with the int8 flags: the classic int8 cache).
    `scores_int8` needs the int8 flags and decodes over that cache with s8
    scores (K7 over the head-minor slabs, plain torch over the classic
    ones).
    prompt_ids: [P] or [B, P] (e.g. cfg.prompt_ids(lang)). `lora` (a bank)
    adapts the cache build and every step, with adapter 0 for the batch or
    `adapter_idx` [B] per row. `segment` as in the module docstring.
    Returns [B, min(P + max_new_tokens, max_target_positions)] int64;
    positions after EOS are EOS."""
    P = torch.as_tensor(prompt_ids).shape[-1]
    total = min(P + max_new_tokens, cfg.max_target_positions)
    cache = whisper.init_cache(params, enc_out, cfg, max_len=total, lora=lora,
                               adapter_idx=adapter_idx, lora_scale=lora_scale,
                               cross_kv_int8=cross_kv_int8,
                               self_kv_int8=self_kv_int8,
                               cross_kv_int4=cross_kv_int4,
                               self_kv_int4=self_kv_int4, head_minor=head_minor,
                               kernels=kernels)
    return greedy_decode_from_cache(params, cache, cfg, prompt_ids, lora=lora,
                                    adapter_idx=adapter_idx,
                                    lora_scale=lora_scale,
                                    scores_int8=scores_int8,
                                    suppress_ids=suppress_ids, segment=segment,
                                    kernels=kernels)


def greedy_segment(params: dict, cache: whisper.DecodeCache,
                   cfg: WhisperConfig, tokens: torch.Tensor,
                   finished: torch.Tensor, lo: int, hi: int, self_len: int,
                   prompt_len: int, *, lora: dict | None = None,
                   adapter_idx=None, lora_scale: float = 1.0,
                   scores_int8: bool = False,
                   suppress: torch.Tensor | None = None,
                   kernels: bool = True) -> None:
    """Positions [lo, hi) of the greedy loop over the first `self_len` rows
    of the self cache, in place on `tokens` [B, total], `finished` [B] and
    the cache. Nothing here reads the device from the host: the body of one
    segment's CUDA graph (decode/graphs.py)."""
    eos = cfg.eos_token_id
    for pos in range(lo, hi):
        logits, cache = whisper.decode_step(params, tokens[:, pos], pos, cache,
                                            cfg, lora=lora,
                                            adapter_idx=adapter_idx,
                                            lora_scale=lora_scale,
                                            scores_int8=scores_int8,
                                            kernels=kernels, self_len=self_len)
        # Prompt positions keep the provided token; finished rows emit EOS.
        if pos + 1 >= prompt_len:
            if suppress is not None:
                logits[:, suppress] = torch.finfo(torch.float32).min
            nxt = torch.where(finished, eos, torch.argmax(logits, dim=-1))
            finished.logical_or_(nxt == eos)
            tokens[:, pos + 1] = nxt
    kind = segments.step_kind(cache, 1, scores_int8)
    segments.STEPS[kind] += hi - lo


@torch.no_grad()
def greedy_decode_from_cache(params: dict, cache: whisper.DecodeCache,
                             cfg: WhisperConfig, prompt_ids, *,
                             lora: dict | None = None, adapter_idx=None,
                             lora_scale: float = 1.0,
                             scores_int8: bool = False,
                             suppress_ids: tuple[int, ...] = (),
                             segment: int = 32,
                             kernels: bool = True) -> torch.Tensor:
    """The decode loop alone, from a prepared DecodeCache; the total length
    is the self cache's max_len. The self cache is written in place.
    `scores_int8` needs the int8 cache (see whisper.decode_step). One
    segment at a time, eagerly, with one host sync per segment."""
    B = cache.cross_k.shape[1]
    dev = cache.cross_k.device
    total = cache.self_k.shape[3]
    prompt = torch.as_tensor(prompt_ids, dtype=torch.int64, device=dev)
    P = prompt.shape[-1]
    tokens = torch.full((B, total), cfg.eos_token_id, dtype=torch.int64, device=dev)
    tokens[:, :P] = prompt
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    suppress = (torch.as_tensor(suppress_ids, dtype=torch.int64, device=dev)
                if suppress_ids else None)
    for lo, hi, self_len in segments.grid(total, segment):
        greedy_segment(params, cache, cfg, tokens, finished, lo, hi, self_len, P,
                       lora=lora, adapter_idx=adapter_idx,
                       lora_scale=lora_scale, scores_int8=scores_int8,
                       suppress=suppress, kernels=kernels)
        if segments.host_flag(finished.all()):
            break
    return tokens


def transcribe_tokens(tokens, cfg: WhisperConfig, prompt_len: int) -> list[list[int]]:
    """Strip the prompt and everything from the first EOS; returns per-row
    id lists (host-side; feed to a tokenizer's decode)."""
    out = []
    arr = tokens.cpu().numpy() if isinstance(tokens, torch.Tensor) else np.asarray(tokens)
    for row in arr:
        body = row[prompt_len:]
        eos_pos = np.nonzero(body == cfg.eos_token_id)[0]
        if eos_pos.size:
            body = body[:eos_pos[0]]
        out.append(body.tolist())
    return out
