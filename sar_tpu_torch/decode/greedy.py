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
self_kv_int8=True`, kernels K2 and K3) on request, or a classic one whose
cross and self sides each take their own precision from their own flags
(plain, int8, or int4, which wins over its side's int8 flag): the nine
(cross, self) pairs of `whisper.cache_kind`, the classic int8 one being
the int8 flags with `head_minor=False`; `scores_int8` takes the decode
steps over an int8 cache to s8 scores (kernel K7 over the head-minor
slabs).

The JAX package's decode options are here with its meanings, all inside
the step so that a captured segment carries them: `begin_suppress_ids`
(masked at the first generated position only), a per-call `prompt_len`
below the prompt buffer's width (positions pos + 1 < prompt_len force the
buffer's token: a tensor `where`, so one program serves every prefix
length), `timestamps` (decode/timestamps.py's grammar), sampling at
`temperature` (Gumbel-max, argmax(logits + T * gumbel(u)), so T = 0 is
exact greedy), `with_logprobs` (the summed log-softmax of each chosen
generated token at temperature 1, the first EOS included, and the count
scored), `with_no_speech` (p(<|nospeech|>) of the raw logits at
`no_speech_pos`) and `max_gen_tokens` (rows past prompt_len +
max_gen_tokens emit EOS and count as finished). The values JAX traces
(prompt_len, temperature, the seed, no_speech_pos, max_gen_tokens) are
0-d device tensors of a `GreedyExtras`, which a runner refills per call.

The uniforms u of the sampler come from a counter-based hash (splitmix64)
of (seed, pos, row, column) in int64 tensor ops, not from a
torch.Generator: a graph replays them with the seed it reads from its
buffer, and the same seed gives the same draws eagerly and captured. They
are not JAX's threefry bits; given the same u, `gumbel_argmax` is JAX's
formula.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sar_tpu_torch.decode import segments
from sar_tpu_torch.decode.timestamps import apply_timestamp_rules
from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import WhisperConfig


class GreedyExtras(NamedTuple):
    """The per-call values and accumulators of the greedy options, each a
    device tensor (None: the option is off). A captured loop bakes in
    which are present and refills their values per call."""
    plen: torch.Tensor                         # 0-d int64, forced-prefix length
    temperature: torch.Tensor | None = None    # 0-d fp32: sampling on
    seed: torch.Tensor | None = None           # 0-d int64
    no_speech_pos: torch.Tensor | None = None  # 0-d int64
    max_gen_tokens: torch.Tensor | None = None  # 0-d int64
    sum_logprobs: torch.Tensor | None = None   # [B] fp32
    n_scored: torch.Tensor | None = None       # [B] int32
    no_speech_prob: torch.Tensor | None = None  # [B] fp32


def make_extras(B: int, device, *, sample: bool = False,
                with_logprobs: bool = False, with_no_speech: bool = False,
                cap: bool = False) -> GreedyExtras:
    """Zeroed buffers of the options asked for (fill them with
    `fill_extras`)."""
    def z(shape=(), dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device=device)
    return GreedyExtras(
        plen=z(), temperature=z(dtype=torch.float32) if sample else None,
        seed=z() if sample else None,
        no_speech_pos=z() if with_no_speech else None,
        max_gen_tokens=z() if cap else None,
        sum_logprobs=z(B, torch.float32) if with_logprobs else None,
        n_scored=z(B, torch.int32) if with_logprobs else None,
        no_speech_prob=z(B, torch.float32) if with_no_speech else None)


def fill_extras(ex: GreedyExtras, *, plen: int, temperature: float = 0.0,
                seed: int = 0, no_speech_pos: int = 0,
                max_gen_tokens: int | None = None) -> None:
    """Write one call's values into `ex` in place and zero its
    accumulators (fills on the device: nothing waits)."""
    ex.plen.fill_(int(plen))
    for buf, v in ((ex.temperature, float(temperature)), (ex.seed, int(seed)),
                   (ex.no_speech_pos, int(no_speech_pos)),
                   (ex.max_gen_tokens, max_gen_tokens)):
        if buf is not None:
            buf.fill_(v)
    for buf in (ex.sum_logprobs, ex.n_scored, ex.no_speech_prob):
        if buf is not None:
            buf.zero_()


def _u64(c: int) -> int:
    """A 64-bit constant as the int64 of the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN = _u64(0x9E3779B97F4A7C15)
_MIX1, _MIX2 = _u64(0xBF58476D1CE4E5B9), _u64(0x94D049BB133111EB)


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's >> is arithmetic)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer over int64 bits (products wrap mod 2^64)."""
    z = (z ^ _srl(z, 30)) * _MIX1
    z = (z ^ _srl(z, 27)) * _MIX2
    return z ^ _srl(z, 31)


def step_uniforms(seed: torch.Tensor, pos: int, rows: int,
                  cols: int) -> torch.Tensor:
    """[rows, cols] fp32 uniforms in [tiny, 1) for step `pos`: 24 bits of
    splitmix64 of (seed, pos, row * cols + col), the counterpart of JAX's
    uniform(fold_in(rng, pos), minval=tiny). Pure tensor ops: capturable,
    and the same bits on any device."""
    key = _mix64(seed * _GOLDEN + pos)
    idx = torch.arange(rows * cols, device=seed.device).view(rows, cols)
    bits = _mix64(key + (idx + 1) * _GOLDEN)
    u = _srl(bits, 40).float() * 2.0 ** -24
    return u.clamp_min(torch.finfo(torch.float32).tiny)


def gumbel_argmax(logits: torch.Tensor, u: torch.Tensor,
                  temperature: torch.Tensor) -> torch.Tensor:
    """JAX's sampler: argmax(logits + T * gumbel(u)) over fp32, gumbel(u) =
    -log(-log(u)); T = 0 is the plain argmax."""
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() + temperature * gumbel, dim=-1)


def greedy_decode(params: dict, enc_out: torch.Tensor, cfg: WhisperConfig,
                  prompt_ids, *, max_new_tokens: int = 256,
                  lora: dict | None = None, adapter_idx=None,
                  lora_scale: float = 1.0,
                  suppress_ids: tuple[int, ...] = (),
                  begin_suppress_ids: tuple[int, ...] = (),
                  prompt_len=None,
                  cross_kv_int8: bool = False, self_kv_int8: bool = False,
                  cross_kv_int4: bool = False, self_kv_int4: bool = False,
                  scores_int8: bool = False, head_minor: bool | None = None,
                  segment: int = 32, timestamps: bool = False,
                  max_initial_timestamp_index: int | None = 1,
                  temperature: float = 0.0, seed: int | None = None,
                  with_logprobs: bool = False, with_no_speech: bool = False,
                  kernels: bool = True, tp=None):
    """Greedy decode over a cache built from `enc_out`: the unquantized
    classic one (the default, the JAX package's), the int8 head-minor one
    with cross_kv_int8 = self_kv_int8 = True (serving's), or a classic one
    of any other (cross, self) pair of precisions, plain, int8 or int4,
    each side by its own flags (an int4 flag supersedes its side's int8
    flag; `whisper.cache_kind`); the layout is `whisper.use_head_minor`'s
    unless `head_minor` says otherwise (head_minor=False with the int8
    flags: the classic int8 cache). `scores_int8` needs both sides int8 and
    decodes with s8 scores (K7 over the head-minor slabs, plain torch over
    the classic ones).
    prompt_ids: [P] or [B, P] (e.g. cfg.prompt_ids(lang)). `lora` (a bank)
    adapts the cache build and every step, with adapter 0 for the batch or
    `adapter_idx` [B] per row. `segment` and the options as in the module
    docstring and `greedy_decode_from_cache`.
    Returns [B, min(P + max_new_tokens, max_target_positions)] int64
    (positions after EOS are EOS), then greedy_decode_from_cache's extra
    outputs when asked. `tp`: the "model" group of a tensor-parallel shard
    of `params` (whisper.init_cache / decode_step)."""
    P = torch.as_tensor(prompt_ids).shape[-1]
    total = min(P + max_new_tokens, cfg.max_target_positions)
    cache = whisper.init_cache(params, enc_out, cfg, max_len=total, lora=lora,
                               adapter_idx=adapter_idx, lora_scale=lora_scale,
                               cross_kv_int8=cross_kv_int8,
                               self_kv_int8=self_kv_int8,
                               cross_kv_int4=cross_kv_int4,
                               self_kv_int4=self_kv_int4, head_minor=head_minor,
                               kernels=kernels, tp=tp)
    return greedy_decode_from_cache(
        params, cache, cfg, prompt_ids, lora=lora, adapter_idx=adapter_idx,
        lora_scale=lora_scale, scores_int8=scores_int8,
        suppress_ids=suppress_ids, begin_suppress_ids=begin_suppress_ids,
        prompt_len=prompt_len, segment=segment, timestamps=timestamps,
        max_initial_timestamp_index=max_initial_timestamp_index,
        temperature=temperature, seed=seed, with_logprobs=with_logprobs,
        with_no_speech=with_no_speech, kernels=kernels, tp=tp)


def greedy_segment(params: dict, cache: whisper.DecodeCache,
                   cfg: WhisperConfig, tokens: torch.Tensor,
                   finished: torch.Tensor, lo: int, hi: int, self_len: int,
                   ex: GreedyExtras, *, lora: dict | None = None,
                   adapter_idx=None, lora_scale: float = 1.0,
                   scores_int8: bool = False,
                   suppress: torch.Tensor | None = None,
                   begin_suppress: torch.Tensor | None = None,
                   timestamps: bool = False,
                   max_initial_timestamp_index: int | None = 1,
                   prompt_width: int | None = None,
                   kernels: bool = True, tp=None) -> None:
    """Positions [lo, hi) of the greedy loop over the first `self_len` rows
    of the self cache, in place on `tokens` [B, total], `finished` [B], the
    accumulators of `ex` and the cache. `prompt_width` (the buffer's
    prompt width, default total) bounds the positions where the no-speech
    probability is read. Nothing here reads the device from the host: the
    body of one segment's CUDA graph (decode/graphs.py)."""
    eos = cfg.eos_token_id
    B, total = tokens.shape
    fmin = torch.finfo(torch.float32).min
    plen = ex.plen
    width = total if prompt_width is None else prompt_width
    for pos in range(lo, hi):
        logits, cache = whisper.decode_step(params, tokens[:, pos], pos, cache,
                                            cfg, lora=lora,
                                            adapter_idx=adapter_idx,
                                            lora_scale=lora_scale,
                                            scores_int8=scores_int8,
                                            kernels=kernels, self_len=self_len,
                                            tp=tp)
        if ex.no_speech_prob is not None and pos < width:
            # p(<|nospeech|>) of the raw logits, kept at no_speech_pos (the
            # position of <|sot|>, which lies inside the prompt buffer).
            p_ns = torch.exp(logits[:, cfg.no_speech_token_id]
                             - torch.logsumexp(logits, dim=-1))
            ex.no_speech_prob.copy_(torch.where(pos == ex.no_speech_pos, p_ns,
                                                ex.no_speech_prob))
        if suppress is not None:
            logits[:, suppress] = fmin
        if begin_suppress is not None:
            masked = logits.index_fill(1, begin_suppress, fmin)
            logits = torch.where(pos == plen - 1, masked, logits)
        if timestamps:
            logits = apply_timestamp_rules(
                logits, tokens, pos, plen, cfg,
                max_initial_timestamp_index=max_initial_timestamp_index)
        if ex.temperature is not None:
            sampled = gumbel_argmax(logits, step_uniforms(ex.seed, pos, *logits.shape),
                                    ex.temperature)
        else:
            sampled = torch.argmax(logits, dim=-1)
        # Prompt positions force the buffer's token; finished rows emit EOS.
        in_prompt = pos + 1 < plen
        if ex.max_gen_tokens is not None:
            past_cap = (pos + 1 - plen) >= ex.max_gen_tokens
            finished.logical_or_(~in_prompt & past_cap)
        nxt = torch.where(in_prompt, tokens[:, pos + 1],
                          torch.where(finished, eos, sampled))
        if ex.sum_logprobs is not None:
            # The chosen token's log-probability at temperature 1.
            step_lp = (torch.gather(logits, 1, nxt[:, None])[:, 0]
                       - torch.logsumexp(logits, dim=-1))
            score = ~in_prompt & ~finished
            ex.sum_logprobs.add_(torch.where(score, step_lp, 0.0))
            ex.n_scored.add_(score.int())
        tokens[:, pos + 1] = nxt
        finished.logical_or_(~in_prompt & (nxt == eos))
    kind = segments.step_kind(cache, 1, scores_int8)
    segments.STEPS[kind] += hi - lo


def _ids_tensor(ids, device) -> torch.Tensor | None:
    return (torch.as_tensor(tuple(ids), dtype=torch.int64, device=device)
            if ids else None)


@torch.no_grad()
def greedy_decode_from_cache(params: dict, cache: whisper.DecodeCache,
                             cfg: WhisperConfig, prompt_ids, *,
                             lora: dict | None = None, adapter_idx=None,
                             lora_scale: float = 1.0,
                             scores_int8: bool = False,
                             suppress_ids: tuple[int, ...] = (),
                             begin_suppress_ids: tuple[int, ...] = (),
                             prompt_len=None, segment: int = 32,
                             timestamps: bool = False,
                             max_initial_timestamp_index: int | None = 1,
                             temperature: float = 0.0, seed: int | None = None,
                             with_logprobs: bool = False,
                             with_no_speech: bool = False,
                             no_speech_pos: int = 0,
                             max_gen_tokens: int | None = None,
                             return_cache: bool = False,
                             kernels: bool = True, tp=None):
    """The decode loop alone, from a prepared DecodeCache; the total length
    is the self cache's max_len. The self cache is written in place.
    `scores_int8` needs the int8 cache (see whisper.decode_step). One
    segment at a time, eagerly, with one host sync per segment.

    The options, as the JAX package's greedy_decode_from_cache takes them:
    `prompt_len` (<= the prompt's width; default the width) is the forced
    prefix; `begin_suppress_ids` are masked at the first generated
    position; `timestamps` applies the grammar; a `seed` turns sampling on
    at `temperature` (T > 0 without a seed raises, as JAX's without an
    rng); `with_logprobs` adds (sum_logprobs [B] fp32, n_scored [B]
    int32), `with_no_speech` adds no_speech_prob [B] fp32 (at
    `no_speech_pos`), `max_gen_tokens` caps the generated tokens per row.
    `return_cache` adds the final DecodeCache: `cache` itself, its cross
    fields as they were and its self fields as the loop left them (rows
    up to the end of the last segment run).
    Returns tokens [B, total] int64, then those in that order, then the
    cache (a flat tuple when any is asked), as the JAX package's."""
    if seed is None and temperature != 0.0:
        raise ValueError("temperature > 0 requires a seed")
    B = cache.cross_k.shape[1]
    dev = cache.cross_k.device
    total = cache.self_k.shape[3]
    prompt = torch.as_tensor(prompt_ids, dtype=torch.int64, device=dev)
    P = prompt.shape[-1]
    tokens = torch.full((B, total), cfg.eos_token_id, dtype=torch.int64, device=dev)
    tokens[:, :P] = prompt
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    ex = make_extras(B, dev, sample=seed is not None, with_logprobs=with_logprobs,
                     with_no_speech=with_no_speech, cap=max_gen_tokens is not None)
    fill_extras(ex, plen=P if prompt_len is None else prompt_len,
                temperature=temperature, seed=seed or 0,
                no_speech_pos=no_speech_pos, max_gen_tokens=max_gen_tokens)
    suppress = _ids_tensor(suppress_ids, dev)
    begin_suppress = _ids_tensor(begin_suppress_ids, dev)
    for lo, hi, self_len in segments.grid(total, segment):
        greedy_segment(params, cache, cfg, tokens, finished, lo, hi, self_len, ex,
                       lora=lora, adapter_idx=adapter_idx,
                       lora_scale=lora_scale, scores_int8=scores_int8,
                       suppress=suppress, begin_suppress=begin_suppress,
                       timestamps=timestamps,
                       max_initial_timestamp_index=max_initial_timestamp_index,
                       prompt_width=P, kernels=kernels, tp=tp)
        if segments.host_flag(finished.all()):
            break
    out = extras_outputs(tokens, ex)
    if not return_cache:
        return out
    return (*(out if isinstance(out, tuple) else (out,)), cache)


def extras_outputs(tokens: torch.Tensor, ex: GreedyExtras):
    """tokens, then (sum_logprobs, n_scored) and no_speech_prob when `ex`
    holds them: JAX's flat output tuple (tokens alone when it is one)."""
    out = (tokens,)
    if ex.sum_logprobs is not None:
        out += (ex.sum_logprobs, ex.n_scored)
    if ex.no_speech_prob is not None:
        out += (ex.no_speech_prob,)
    return out if len(out) > 1 else tokens


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
