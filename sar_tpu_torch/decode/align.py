"""Word-level timestamps by cross-attention DTW (counterpart of
sar_tpu/decode/align.py; openai-whisper's find_alignment and
add_word_timestamps).

  1. One teacher-forced decoder pass over the decode output buffer
     (prompt + text + EOS) keeps the cross-attention probabilities of the
     alignment heads (`whisper.decode_cross_attn`, exact attention, on the
     device).
  2. On the device: per-(head, frame) standardization over the valid
     token rows, a median filter (width 7, reflect padding) along frames,
     the mean over heads -> one [T, S] matrix per utterance.
  3. On the host: monotone DTW over the negated matrix (native/dtw.cpp
     through utils/native.py, else the numpy DP with the same
     tie-breaking) -> each token's first aligned frame (20 ms each); the
     trailing EOS row closes the last word.
  4. Tokens merge into words on unicode and whitespace/punctuation
     boundaries (openai's split_tokens_on_spaces).

Alignment heads: a checkpoint's own (layer, head) list when its config
carries one (HF generation_config `alignment_heads`), else every head of
the upper half of the decoder layers.
"""

from __future__ import annotations

import string

import numpy as np
import torch

from sar_tpu_torch.decode.greedy import transcribe_tokens
from sar_tpu_torch.models import whisper
from sar_tpu_torch.utils import native

# One encoder frame = 2 mel hops = 20 ms of audio.
FRAME_SECONDS = 0.02

# openai split_tokens_on_spaces uses string.punctuation; the CJK marks
# extend it for the non-ASCII scripts this framework targets.
_PUNCT = set(string.punctuation) | set("。，！？：”、")


def default_alignment_heads(cfg) -> tuple[tuple[int, int], ...]:
    """The checkpoint's own alignment_heads when the config carries them
    (convert.config_from_hf imports HF generation_config's list), else all
    heads of the upper half of decoder layers — the standard heuristic."""
    if getattr(cfg, "alignment_heads", None):
        return tuple(cfg.alignment_heads)
    lo = cfg.decoder_layers // 2
    return tuple((l, h) for l in range(lo, cfg.decoder_layers)
                 for h in range(cfg.decoder_heads))


def median_filter(x: torch.Tensor, width: int = 7) -> torch.Tensor:
    """Median filter along the last axis, reflect padding (openai's
    timing.median_filter): the window's middle value, the mean of the two
    middle ones for an even width, as jnp.median."""
    if width <= 1 or x.shape[-1] <= width // 2:
        return x
    pad = width // 2
    left = x[..., 1:pad + 1].flip(-1)
    right = x[..., -pad - 1:-1].flip(-1)
    xp = torch.cat([left, x, right], dim=-1)
    win = xp.unfold(-1, width, 1)[..., :x.shape[-1], :]
    if width % 2:
        return win.sort(dim=-1).values[..., width // 2]
    srt = win.sort(dim=-1).values
    return (srt[..., width // 2 - 1] + srt[..., width // 2]) / 2


@torch.no_grad()
def alignment_matrix(params, enc_out, tokens, cfg, heads, prompt_len,
                     lora=None, adapter_idx=None, lora_scale: float = 1.0,
                     medfilt_width: int = 7
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """([B, T, S] fp32 saliency matrix, [B, T] fp32 next-token probs)
    (steps 1-2 of the module pipeline).

    `tokens` is the decode output buffer [B, T]; only rows
    prompt_len..first-EOS are statistically valid (the standardization
    masks the rest; callers slice rows per utterance before the DTW)."""
    probs, tprobs = whisper.decode_cross_attn(
        params, enc_out, tokens, cfg, heads=heads, lora=lora,
        adapter_idx=adapter_idx, lora_scale=lora_scale,
        with_token_probs=True)                            # [B,n,T,S]
    T = tokens.shape[1]
    pos = torch.arange(T, device=tokens.device)
    is_eos = (tokens == cfg.eos_token_id) & (pos[None] >= prompt_len)
    first_eos = torch.where(is_eos.any(1), is_eos.int().argmax(1), T - 1)
    valid = (pos[None] >= prompt_len) & (pos[None] <= first_eos[:, None])
    m = valid[:, None, :, None]
    cnt = valid.sum(1).clamp_min(1).float()[:, None, None, None]
    mean = torch.where(m, probs, 0.0).sum(2, keepdim=True) / cnt
    var = torch.where(m, (probs - mean).square(), 0.0).sum(2, keepdim=True) / cnt
    w = (probs - mean) * torch.rsqrt(var + 1e-8)
    w = median_filter(w, medfilt_width)
    return w.mean(dim=1), tprobs


def dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Minimum-cost monotone path through cost[N, M] from (0,0) to
    (N-1,M-1); returns (token_indices, frame_indices) in forward order.
    Native C++ (native/dtw.cpp) when available, else the numpy twin —
    identical paths by construction (same tie-breaking)."""
    cost = np.ascontiguousarray(cost, np.float32)
    out = native.dtw(cost)
    if out is not None:
        return out
    return _dtw_numpy(cost)


def _dtw_numpy(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    N, M = x.shape
    cost = np.full((N + 1, M + 1), np.inf, np.float32)
    trace = np.full((N + 1, M + 1), -1, np.int8)
    cost[0, 0] = 0.0
    for i in range(1, N + 1):
        prev, cur, tr, xr = cost[i - 1], cost[i], trace[i], x[i - 1]
        for j in range(1, M + 1):
            c0, c1, c2 = prev[j - 1], prev[j], cur[j - 1]
            if c0 < c1 and c0 < c2:
                c, t = c0, 0
            elif c1 < c0 and c1 < c2:
                c, t = c1, 1
            else:
                c, t = c2, 2
            cur[j] = xr[j - 1] + c
            tr[j] = t
    trace[0, :] = 2
    trace[:, 0] = 1
    i, j, ti, tj = N, M, [], []
    while i > 0 or j > 0:
        ti.append(i - 1)
        tj.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return (np.asarray(ti[::-1], np.int32), np.asarray(tj[::-1], np.int32))


def split_tokens_on_unicode(ids, tokenizer):
    """Smallest token groups whose decode is valid unicode (openai's
    split_tokens_on_unicode: a byte-level BPE can split one codepoint
    across tokens; U+FFFD marks the seam unless the full decode really
    contains U+FFFD at that offset)."""
    replacement = "�"
    full = tokenizer.decode(list(ids))
    pieces, piece_tokens, cur, offset = [], [], [], 0
    for tid in ids:
        cur.append(int(tid))
        dec = tokenizer.decode(cur)
        pos = dec.find(replacement)
        if pos == -1 or (offset + pos < len(full)
                         and full[offset + pos] == replacement):
            pieces.append(dec)
            piece_tokens.append(cur)
            cur = []
            offset += len(dec)
    if cur:
        pieces.append(tokenizer.decode(cur))
        piece_tokens.append(cur)
    return pieces, piece_tokens


def split_words(ids, tokenizer) -> tuple[list[str], list[int]]:
    """Merge tokens into whitespace/punctuation-delimited words; returns
    (words, tokens_per_word) with sum(tokens_per_word) == len(ids)."""
    pieces, piece_tokens = split_tokens_on_unicode(ids, tokenizer)
    words: list[str] = []
    counts: list[int] = []
    for piece, toks in zip(pieces, piece_tokens):
        starts = (not words or piece.startswith((" ", "\n", "\t"))
                  or piece.strip() in _PUNCT)
        if starts and words and not words[-1].strip():
            starts = False          # glue leading whitespace runs forward
        if starts:
            words.append(piece)
            counts.append(len(toks))
        else:
            words[-1] += piece
            counts[-1] += len(toks)
    return [w.strip() for w in words], counts


def words_from_matrix(matrix: np.ndarray, ids, tokenizer,
                      *, frame_seconds: float = FRAME_SECONDS,
                      token_probs=None, with_bounds: bool = False):
    """DTW a single utterance's saliency matrix into word timings.

    matrix: [n_text + 1, S] (text-token rows then the EOS row — the EOS
    row's first aligned frame closes the last word), or [n_text, S] when
    the decode filled its buffer without emitting EOS (the window end
    closes the last word instead). Returns [{"word", "start", "end",
    "probability"}] with monotone non-decreasing starts; probability is
    the mean token probability over the word's tokens (openai's word
    probability; 0.0 when `token_probs` is not given).

    `with_bounds=True` additionally returns each word's [b0, b1) token
    span into `ids` — the key for assigning words to timestamp segments
    (openai add_word_timestamps walks segments by token counts)."""
    n = len(ids)
    if n == 0 or matrix.shape[0] not in (n, n + 1):
        return ([], []) if with_bounds else []
    ti, tj = dtw_path(-np.asarray(matrix, np.float32))
    jumps = np.pad(np.diff(ti), (1, 0), constant_values=1).astype(bool)
    token_start = tj[jumps] * frame_seconds          # one per matrix row
    if matrix.shape[0] == n:
        token_start = np.append(token_start, matrix.shape[1] * frame_seconds)
    words, counts = split_words(ids, tokenizer)
    bounds = np.pad(np.cumsum(counts), (1, 0))
    out = []
    spans = []
    for w, b0, b1 in zip(words, bounds[:-1], bounds[1:]):
        if not w:
            continue
        prob = (float(np.mean(token_probs[b0:b1]))
                if token_probs is not None and b1 > b0 else 0.0)
        out.append({"word": w,
                    "start": float(token_start[b0]),
                    "end": float(token_start[min(b1, len(token_start) - 1)]),
                    "probability": prob})
        spans.append((int(b0), int(b1)))
    if with_bounds:
        return out, spans
    return out


def align_words(params, mel, tokens, cfg, tokenizer, *, prompt_len: int,
                heads=None, num_frames=None, lora=None, adapter_idx=None,
                lora_scale: float = 1.0, enc_out=None,
                medfilt_width: int = 7, with_bounds: bool = False):
    """Word timings for a decoded batch.

    mel: [B, n_mels, frames]; tokens: the greedy/beam output buffer
    [B, total] (prompt + text + EOS padding); num_frames: per-row count of
    VALID encoder frames (unpadded audio length / 320 samples), or None for
    the full window. Returns one [{"word", "start", "end"}] list per row;
    with_bounds=True returns (word lists, per-word [b0, b1) token spans).
    Pass `enc_out` to reuse an encoder forward you already have."""
    heads = tuple(heads) if heads is not None else default_alignment_heads(cfg)
    if enc_out is None:
        enc_out = whisper.encode(params, mel, cfg, lora=lora,
                                 lora_scale=lora_scale)
    ids_rows = transcribe_tokens(tokens, cfg, prompt_len=prompt_len)
    max_n = max((len(r) for r in ids_rows), default=0)
    if max_n == 0:
        empty = [[] for _ in ids_rows]
        return (empty, [[] for _ in ids_rows]) if with_bounds else empty
    # The token span rounded up to a 32 multiple, as the JAX package bounds
    # its retraces (the same rows, so the same statistics).
    T_used = min(-(-(prompt_len + max_n + 1) // 32) * 32, tokens.shape[1])
    tokens = torch.as_tensor(tokens).to(enc_out.device, torch.int64)
    matrix, tprobs = alignment_matrix(
        params, enc_out, tokens[:, :T_used], cfg, heads,
        prompt_len, lora=lora, adapter_idx=adapter_idx,
        lora_scale=lora_scale, medfilt_width=medfilt_width)
    matrix, tprobs = matrix.cpu().numpy(), tprobs.cpu().numpy()
    S = matrix.shape[-1]
    out = []
    out_bounds = []
    for b, ids in enumerate(ids_rows):
        n = len(ids)
        if n == 0:
            out.append([])
            out_bounds.append([])
            continue
        S_b = S if num_frames is None else max(2, min(int(num_frames[b]), S))
        rows = matrix[b, prompt_len:prompt_len + n + 1, :S_b]
        # Token at buffer index prompt_len+i is scored by the logits one
        # position earlier: tprobs[t] = p(tokens[t+1] | prefix<=t).
        row_out = words_from_matrix(
            rows, ids, tokenizer,
            token_probs=tprobs[b, prompt_len - 1:prompt_len + n - 1],
            with_bounds=with_bounds)
        if with_bounds:
            out.append(row_out[0])
            out_bounds.append(row_out[1])
        else:
            out.append(row_out)
    return (out, out_bounds) if with_bounds else out
