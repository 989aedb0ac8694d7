"""Whisper's timestamp grammar as tensor ops (counterpart of
sar_tpu/decode/timestamps.py).

`apply_timestamp_rules` masks one step's logits [R, V] with the rules of
HF's WhisperTimeStampLogitsProcessor (openai-whisper's ApplyTimestampRules)
as the JAX package applies them inside its decode loops:

  1. `<|notimestamps|>` is always suppressed.
  2. Timestamps come in pairs, except directly before EOS: after a lone
     timestamp only timestamps or EOS may follow; after a completed pair
     the next token is text.
  3. Timestamps never decrease; a repeated one only closes a pair.
  4. At the first generated position only timestamps are allowed, capped
     at `max_initial_timestamp_index` above `<|0.00|>`.
  5. If the timestamps' total probability exceeds the most likely text
     token's, text is masked.

Everything is a tensor op over the sequence buffer with no read on the
host, so the rules run inside a captured decode segment
(decode/graphs.py): `pos` is the segment's Python position and `plen`
the forced-prefix length, a Python int or a 0-d device tensor (the
captured loop refills it per call). Masked entries are -inf, as in the
JAX package; the suppress lists upstream use finfo.min, so no row that
reaches rule 5 is all -inf.

Timestamp token `timestamp_begin + i` means i * 0.02 s. `split_segments`
and `format_segments` are the host-side splitters of a decoded row.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def apply_timestamp_rules(logits: torch.Tensor, tokens: torch.Tensor, pos: int,
                          plen, cfg, *,
                          max_initial_timestamp_index: int | None = 1,
                          detect_from_logprob: bool = True) -> torch.Tensor:
    """Mask step logits per the Whisper timestamp grammar; returns a new
    tensor.

    logits: [R, V] fp32, the step's logits (suppress lists applied).
    tokens: [R, total] int64, the sequence buffer; positions <= pos are
        the prompt and the tokens generated so far.
    pos: the position of the token just consumed; the chosen token lands
        at pos + 1.
    plen: the prompt length (HF's begin_index): generated tokens occupy
        [plen, pos]."""
    V = logits.shape[1]
    total = tokens.shape[1]
    dev = logits.device
    ts_begin = cfg.no_timestamps_token_id + 1
    cols = torch.arange(V, device=dev)
    is_ts_col = cols >= ts_begin
    neg_inf = torch.full((), NEG_INF, device=dev)

    # 1. <|notimestamps|> is never chosen on the timestamp path.
    logits = torch.where(cols == cfg.no_timestamps_token_id, neg_inf, logits)

    n_gen = pos + 1 - plen
    last_tok = tokens[:, pos]
    prev_tok = tokens[:, max(pos - 1, 0)]
    last_was = (n_gen >= 1) & (last_tok >= ts_begin)
    penult_was = (n_gen < 2) | (prev_tok >= ts_begin)

    # 2. Pair rule.
    logits = torch.where((last_was & penult_was)[:, None] & is_ts_col[None],
                         neg_inf, logits)
    logits = torch.where((last_was & ~penult_was)[:, None]
                         & (cols < cfg.eos_token_id)[None], neg_inf, logits)

    # 3. Monotonic rule: the threshold is the latest generated timestamp
    #    (+1 unless it is the lone opening half of a pair).
    idxs = torch.arange(total, device=dev)
    in_gen = (idxs[None] >= plen) & (idxs[None] <= pos)
    is_ts = (tokens >= ts_begin) & in_gen
    any_ts = is_ts.any(dim=1)
    last_ts_idx = torch.where(is_ts, idxs[None], -1).amax(dim=1)
    ts_last_val = torch.gather(tokens, 1, last_ts_idx.clamp_min(0)[:, None])[:, 0]
    thr = torch.where(last_was & ~penult_was, ts_last_val, ts_last_val + 1)
    mono = any_ts[:, None] & is_ts_col[None] & (cols[None] < thr[:, None])
    logits = torch.where(mono, neg_inf, logits)

    # 4. First generated position: timestamps only, capped near <|0.00|>.
    initial = pos == plen - 1
    init_mask = ~is_ts_col
    if max_initial_timestamp_index is not None:
        init_mask = init_mask | (cols > ts_begin + max_initial_timestamp_index)
    logits = torch.where(initial & init_mask[None], neg_inf, logits)

    # 5. Probability rule, on the masked logits.
    if detect_from_logprob:
        logprobs = torch.log_softmax(logits, dim=-1)
        ts_lp = torch.logsumexp(torch.where(is_ts_col[None], logprobs, neg_inf),
                                dim=-1)
        max_text = torch.where(is_ts_col[None], neg_inf, logprobs).amax(dim=-1)
        logits = torch.where((ts_lp > max_text)[:, None] & ~is_ts_col[None],
                             neg_inf, logits)
    return logits


def split_segments(ids, cfg, prompt_len: int = 0):
    """Host-side: split a decoded row into (start_s, end_s, token_list)
    segments on its timestamp tokens. Tokens before the first timestamp
    (or all of them, if none) come back as one (None, None, tokens)
    segment. `ids` is a 1-D sequence already stripped of the prompt and
    EOS (e.g. `transcribe_tokens` output)."""
    ts_begin = cfg.no_timestamps_token_id + 1
    segments = []
    cur_start = None
    cur: list[int] = []
    for t in list(ids)[prompt_len:]:
        t = int(t)
        if t >= ts_begin:
            stamp = (t - ts_begin) * 0.02
            if cur_start is None:
                if cur:
                    segments.append((None, None, cur))
                    cur = []
                cur_start = stamp
            else:
                segments.append((cur_start, stamp, cur))
                cur, cur_start = [], None
        else:
            cur.append(t)
    if cur or cur_start is not None:
        segments.append((cur_start, None, cur))
    return segments


def format_segments(segments, tokenizer) -> str:
    """Render split_segments output as '[0.00 -> 1.24] text' lines."""
    lines = []
    for start, end, toks in segments:
        text = tokenizer.decode(toks).strip()
        if not text:
            continue
        if start is None:
            lines.append(text)
        else:
            end_s = f"{end:.2f}" if end is not None else "?"
            lines.append(f"[{start:.2f} -> {end_s}] {text}")
    return "\n".join(lines)
