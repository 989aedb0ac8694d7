"""KV-cached greedy decoding (counterpart of sar_tpu/decode/greedy.py).

The JAX package runs the loop as one `lax.while_loop`; here it is a host
loop over positions with the same semantics: the decoder prompt
`<|sot|><|lang|><|task|><|notimestamps|>` is fed through the loop (prompt
positions force the next token instead of taking the argmax), rows that
emitted EOS keep emitting EOS, and the loop stops early once every row has
finished (one host sync per step reads that flag). Suppress-token masking
is available and off by default.

The cache is, as in the JAX package, the unquantized classic one by
default; the int8 head-minor one of serving (`cross_kv_int8=True,
self_kv_int8=True`, kernels K2 and K3), or the int4 classic one
(`cross_kv_int4=True, self_kv_int4=True`) on request; `scores_int8` takes
the decode steps over the int8 cache to s8 scores (kernel K7). The self cache
is allocated at the full length `total`: the reference's
`segment` option only shortens the self-attention buffers and yields tokens
identical to `segment=0`. Sampling, timestamps, logprobs and segmenting
wait for later slices of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import WhisperConfig


def greedy_decode(params: dict, enc_out: torch.Tensor, cfg: WhisperConfig,
                  prompt_ids, *, max_new_tokens: int = 256,
                  lora: dict | None = None, adapter_idx=None,
                  lora_scale: float = 1.0,
                  suppress_ids: tuple[int, ...] = (),
                  cross_kv_int8: bool = False, self_kv_int8: bool = False,
                  cross_kv_int4: bool = False, self_kv_int4: bool = False,
                  scores_int8: bool = False,
                  kernels: bool = True) -> torch.Tensor:
    """Greedy decode over a cache built from `enc_out`: the unquantized
    classic one (the default, the JAX package's), the int8 head-minor one
    with cross_kv_int8 = self_kv_int8 = True (serving's), or the int4
    classic one (the int4 flags supersede the int8 ones); the layout is
    `whisper.use_head_minor`'s. `scores_int8` needs the int8 flags and
    decodes over that cache with s8 scores (K7).
    prompt_ids: [P] or [B, P] (e.g. cfg.prompt_ids(lang)). `lora` (a bank)
    adapts the cache build and every step, with adapter 0 for the batch or
    `adapter_idx` [B] per row.
    Returns [B, min(P + max_new_tokens, max_target_positions)] int64;
    positions after EOS are EOS."""
    P = torch.as_tensor(prompt_ids).shape[-1]
    total = min(P + max_new_tokens, cfg.max_target_positions)
    cache = whisper.init_cache(params, enc_out, cfg, max_len=total, lora=lora,
                               adapter_idx=adapter_idx, lora_scale=lora_scale,
                               cross_kv_int8=cross_kv_int8,
                               self_kv_int8=self_kv_int8,
                               cross_kv_int4=cross_kv_int4,
                               self_kv_int4=self_kv_int4, kernels=kernels)
    return greedy_decode_from_cache(params, cache, cfg, prompt_ids, lora=lora,
                                    adapter_idx=adapter_idx,
                                    lora_scale=lora_scale,
                                    scores_int8=scores_int8,
                                    suppress_ids=suppress_ids, kernels=kernels)


@torch.no_grad()
def greedy_decode_from_cache(params: dict, cache: whisper.DecodeCache,
                             cfg: WhisperConfig, prompt_ids, *,
                             lora: dict | None = None, adapter_idx=None,
                             lora_scale: float = 1.0,
                             scores_int8: bool = False,
                             suppress_ids: tuple[int, ...] = (),
                             kernels: bool = True) -> torch.Tensor:
    """The decode loop alone, from a prepared DecodeCache; the total length
    is the self cache's max_len. The self cache is written in place.
    `scores_int8` needs the int8 cache (see whisper.decode_step)."""
    B = cache.cross_k.shape[1]
    dev = cache.cross_k.device
    prompt = torch.as_tensor(prompt_ids, dtype=torch.int64, device=dev)
    if prompt.dim() == 1:
        prompt = prompt[None].expand(B, -1)
    P = prompt.shape[1]
    total = cache.self_k.shape[3]
    eos = cfg.eos_token_id

    tokens = torch.full((B, total), eos, dtype=torch.int64, device=dev)
    tokens[:, :P] = prompt
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    suppress = (torch.as_tensor(suppress_ids, dtype=torch.int64, device=dev)
                if suppress_ids else None)
    for pos in range(total - 1):
        if bool(finished.all()):
            break
        logits, cache = whisper.decode_step(params, tokens[:, pos], pos, cache,
                                            cfg, lora=lora,
                                            adapter_idx=adapter_idx,
                                            lora_scale=lora_scale,
                                            scores_int8=scores_int8,
                                            kernels=kernels)
        if suppress is not None:
            logits[:, suppress] = torch.finfo(torch.float32).min
        # Prompt positions force the provided token; finished rows emit EOS.
        if pos + 1 < P:
            nxt = tokens[:, pos + 1]
        else:
            sampled = torch.argmax(logits, dim=-1)
            nxt = torch.where(finished, eos, sampled)
            finished = finished | (nxt == eos)
        tokens[:, pos + 1] = nxt
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
