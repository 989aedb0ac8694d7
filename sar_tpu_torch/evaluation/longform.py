"""Long-form transcription: audio beyond Whisper's 30 s window
(counterpart of sar_tpu/evaluation/longform.py).

The waveform splits into 30 s chunks (`chunk_audio_with_offsets`), which
transcribe as batches through `batch_transcribe` (mel, encode, greedy over
the unquantized classic cache, the JAX package's default) and join in
order; `overlap_seconds` re-cues the acoustic context, and overlapping
windows' ids merge with the HF pipeline's longest-common-sequence rule
(`merge_overlapping_ids`).

The extras of openai-whisper's transcribe loop ride the
FallbackTranscriber (evaluation/fallback.py: K1, K2 and K3 on the card,
the captured loop replayed per pass): `fallback=True` (temperature
escalation and the no-speech skip), `word_timestamps=True` (the
cross-attention DTW aligner, decode/align.py, words on the global clock),
`timestamps=True` (the timestamp grammar, segments on the global clock),
sampling temperatures, and the sequential conditioned loop
(`condition_on_previous_text`, `initial_prompt`, `carry_initial_prompt`,
`hallucination_silence_threshold`): `<|startofprev|>` + the previous
windows' text in the prompt buffer, the reset after a window accepted at
T > 0.5, the timestamp seek and openai's hallucination-silence skip. Every
window of that loop replays one captured program: the prompt length is a
value the runner refills, not part of its key.

Everything runs on the card unless `device` says otherwise; params and
the adapter bank are moved there once per call.
"""

from __future__ import annotations

import numpy as np
import torch

from sar_tpu_torch.device import resolve_device, tree_to
from sar_tpu_torch.models import frontend
from sar_tpu_torch.ops import mel as mel_ops


def window_features(chunks, cfg, device, batch: int | None = None, *,
                    params: dict | None = None) -> torch.Tensor:
    """bf16 encoder features [batch, n_mels, frames] of the chunks' 30 s
    windows through the config's frontend (models/frontend.py; an ESPnet
    config reads `params`' "mvn"), padded with silent clips to `batch` (as
    the JAX package's long-form computes them, whatever the weights'
    dtype)."""
    return frontend.features(list(chunks), cfg, params, dtype=torch.bfloat16,
                             device=device, rows=batch)


def chunk_audio(audio: np.ndarray, chunk_seconds: float = 30.0,
                overlap_seconds: float = 0.0,
                sample_rate: int = mel_ops.SAMPLE_RATE) -> list[np.ndarray]:
    """Split a waveform into fixed chunks (last one short)."""
    return [c for c, _ in chunk_audio_with_offsets(
        audio, chunk_seconds, overlap_seconds, sample_rate)]


def chunk_audio_with_offsets(
        audio: np.ndarray, chunk_seconds: float = 30.0,
        overlap_seconds: float = 0.0,
        sample_rate: int = mel_ops.SAMPLE_RATE
) -> list[tuple[np.ndarray, float]]:
    """(chunk, start_seconds) pairs — offsets anchor per-chunk word times
    on the global clock."""
    chunk = int(chunk_seconds * sample_rate)
    hop = chunk - int(overlap_seconds * sample_rate)
    if hop <= 0:
        raise ValueError("overlap must be smaller than the chunk size")
    audio = np.asarray(audio, np.float32)
    if len(audio) <= chunk:
        return [(audio, 0.0)]
    out: list[tuple[np.ndarray, float]] = []
    for start in range(0, len(audio), hop):
        piece = audio[start:start + chunk]
        if len(piece) < int(0.2 * sample_rate) and out:
            break                       # ignore a sub-200ms tail
        out.append((piece, start / sample_rate))
        if start + chunk >= len(audio):
            break
    return out


def merge_overlapping_ids(sequences: list[list[int]]) -> list[int]:
    """Stitch per-chunk token sequences decoded from OVERLAPPING windows
    into one sequence (the HF Whisper pipeline's chunk-merge algorithm,
    transformers tokenization_whisper._find_longest_common_sequence —
    verified against the installed implementation in
    tests/test_longform.py): slide the right sequence over the left's
    tail, score each lag by matches/lag (+ a tiny lag-proportional epsilon
    so longer matches win ties), and cut both sides at the midpoint of the
    best-matching span."""
    seqs = [list(map(int, s)) for s in sequences if len(s)]
    if not seqs:
        return []
    left = seqs[0]
    total: list[int] = []
    for right in seqs[1:]:
        ll, rl = len(left), len(right)
        best = 0.0
        best_idx = (ll, ll, 0, 0)
        for i in range(1, ll + rl):
            eps = i / 10000.0
            l0, l1 = max(0, ll - i), min(ll, ll + rl - i)
            r0, r1 = max(0, i - ll), min(rl, i)
            lseg = np.asarray(left[l0:l1])
            rseg = np.asarray(right[r0:r1])
            matches = int(np.sum(lseg == rseg))
            score = matches / i + eps
            if matches > 1 and score > best:
                best = score
                best_idx = (l0, l1, r0, r1)
        l0, l1, r0, r1 = best_idx
        total.extend(left[:(l1 + l0) // 2])
        left = right[(r1 + r0) // 2:]
    total.extend(left)
    return total


def transcribe_long(audio: np.ndarray, cfg, params, tokenizer,
                    language: str = "hindi", max_new_tokens: int = 256,
                    chunk_seconds: float = 30.0,
                    overlap_seconds: float = 0.0,
                    batch_size: int = 8, lora: dict | None = None,
                    lora_scale: float = 1.0, fallback: bool = False,
                    no_speech_threshold: float | None = 0.6,
                    logprob_threshold: float | None = -1.0,
                    word_timestamps: bool = False,
                    timestamps: bool = False,
                    condition_on_previous_text: bool = False,
                    initial_prompt: str | None = None,
                    task: str = "transcribe", best_of: int = 1,
                    timestamp_seek: bool = True,
                    carry_initial_prompt: bool = False,
                    temperatures=None,
                    compression_ratio_threshold: float | None = 2.4,
                    hallucination_silence_threshold: float | None = None,
                    device: torch.device | str | None = None):
    """Transcribe arbitrarily long audio.

    Returns the joined text; (text, words) when `word_timestamps=True` —
    words are [{"word", "start", "end"}] on the global clock, in order; or
    (text, segments) when `timestamps=True` — each window decodes with the
    Whisper timestamp grammar and its (start, end, text) segments land on
    the global clock (chunk offsets applied). BOTH flags together return
    (text, segments, words): timestamp-grammar segments plus DTW-aligned
    words (openai's combined output shape — its word path always runs
    under the grammar).

    `fallback=True` runs each window through the openai-style robust
    decode (evaluation/fallback.py): temperature escalation on degenerate
    output, plus the no-speech gate — windows with
    p(<|nospeech|>) > no_speech_threshold and unconfident text are
    dropped as silence (openai transcribe.py's exact skip rule).

    `condition_on_previous_text=True` / `initial_prompt` switch to the
    SEQUENTIAL conditioned loop (openai's default transcribe behavior):
    each window's decoder prompt carries `<|startofprev|>` + the previous
    windows' text (reset after any window accepted at temperature > 0.5,
    openai's prompt-reset rule), trading the batched windows' throughput
    for cross-window consistency. The context length is a value the
    runner refills per window, so every window replays one captured
    program.

    With `timestamps=True` the conditioned loop also SEEKS by predicted
    timestamps (openai's window-advance rule): when a window's output ends
    with a closed segment, only the audio up to that segment's end is
    consumed; a trailing OPEN segment after closed ones is dropped and its
    audio re-decoded in the next window. `timestamp_seek=False` restores
    fixed strides. openai's full transcribe loop is therefore
    `condition_on_previous_text=True, timestamps=True, fallback=True`.

    `hallucination_silence_threshold` (seconds; openai transcribe.py):
    requires BOTH timestamps and word_timestamps — segments whose aligned
    words look hallucinated (evaluation/hallucination.py) make the seek
    skip the silent gap around them instead of transcribing it. Runs the
    sequential loop (it adjusts the seek) even without conditioning.

    `lora` is a bank whose adapter 0 adapts every window. Runs on the card
    unless `device` says otherwise."""
    if hallucination_silence_threshold is not None and not (
            timestamps and word_timestamps):
        raise ValueError(
            "hallucination_silence_threshold needs timestamps=True and "
            "word_timestamps=True (the heuristics score per-segment words)")
    device = resolve_device(device)
    params = tree_to(params, device)
    if lora is not None:
        lora = tree_to(lora, device, params["decoder"]["token_embed"].dtype)
    if (condition_on_previous_text or initial_prompt is not None
            or hallucination_silence_threshold is not None):
        return _transcribe_long_conditioned(
            audio, cfg, params, tokenizer, language=language,
            max_new_tokens=max_new_tokens, lora=lora, lora_scale=lora_scale,
            fallback=fallback, no_speech_threshold=no_speech_threshold,
            logprob_threshold=logprob_threshold, timestamps=timestamps,
            word_timestamps=word_timestamps,
            condition=condition_on_previous_text,
            initial_prompt=initial_prompt, task=task, best_of=best_of,
            chunk_seconds=chunk_seconds, overlap_seconds=overlap_seconds,
            timestamp_seek=timestamp_seek,
            carry_initial_prompt=carry_initial_prompt,
            temperatures=temperatures,
            compression_ratio_threshold=compression_ratio_threshold,
            hallucination_silence_threshold=hallucination_silence_threshold,
            device=device)
    pairs = chunk_audio_with_offsets(audio, chunk_seconds, overlap_seconds)
    chunks = [c for c, _ in pairs]
    sampled = bool(temperatures) and any(t > 0 for t in temperatures)
    if (not fallback and not word_timestamps and not timestamps
            and not sampled):
        from sar_tpu_torch.evaluation.evaluator import batch_transcribe
        if overlap_seconds > 0 and len(chunks) > 1:
            # Overlapping windows re-transcribe the overlap; merge the
            # token sequences (HF pipeline chunk-merge) so the joined text
            # has no duplicated boundary speech. Still ONE batched decode.
            ids = batch_transcribe(chunks, cfg, params, tokenizer,
                                   language=language, batch_size=batch_size,
                                   max_new_tokens=max_new_tokens, lora=lora,
                                   lora_scale=lora_scale, task=task,
                                   return_ids=True, device=device)
            return tokenizer.decode(merge_overlapping_ids(ids)).strip()
        texts = batch_transcribe(chunks, cfg, params, tokenizer,
                                 language=language, batch_size=batch_size,
                                 max_new_tokens=max_new_tokens, lora=lora,
                                 lora_scale=lora_scale, task=task,
                                 device=device)
        return " ".join(t.strip() for t in texts if t.strip())

    from sar_tpu_torch.evaluation.fallback import (FallbackTranscriber,
                                                   should_skip_silence)
    # One transcriber across all groups: its runner captures once and every
    # 30 s window replays. With fallback off it runs a single T = 0 pass,
    # exact greedy, so the word-timestamp path shares the same engine.
    transcriber = FallbackTranscriber(
        cfg, params, tokenizer, language=language,
        max_new_tokens=max_new_tokens, lora=lora, lora_scale=lora_scale,
        timestamps=timestamps, task=task, best_of=best_of, device=device,
        **({"logprob_threshold": logprob_threshold,
            "no_speech_threshold": no_speech_threshold,
            "compression_ratio_threshold": compression_ratio_threshold,
            **({"temperatures": temperatures} if temperatures else {})}
           if fallback
           else {"temperatures": temperatures or (0.0,),
                 "compression_ratio_threshold": None,
                 "logprob_threshold": None}))
    prompt = cfg.prompt_ids(language, task, no_timestamps=not timestamps)
    P = len(prompt)
    eos = cfg.eos_token_id
    texts: list[str] = []
    words: list[dict] = []
    segments: list[tuple] = []
    for s in range(0, len(chunks), batch_size):
        group = pairs[s:s + batch_size]
        n = len(group)
        feats = window_features([c for c, _ in group], cfg, device, batch_size,
                                params=params)
        group_texts, info = transcriber(feats, n_valid=n)
        kept = []
        for b, (text, row) in enumerate(zip(group_texts[:n], info[:n])):
            if fallback and should_skip_silence(
                    row, no_speech_threshold=no_speech_threshold,
                    logprob_threshold=logprob_threshold):
                continue
            kept.append(b)
            texts.append(text)
            if timestamps:
                from sar_tpu_torch.decode.timestamps import split_segments
                off = group[b][1]
                for t0, t1, toks in split_segments(row["ids"], cfg):
                    seg_text = tokenizer.decode(toks).strip()
                    if not seg_text:
                        continue
                    segments.append((
                        None if t0 is None else round(t0 + off, 2),
                        None if t1 is None else round(t1 + off, 2),
                        seg_text))
        if word_timestamps and kept:
            from sar_tpu_torch.decode.align import align_words
            # Rebuild the decode buffers from the ACCEPTED ids (the
            # escalation may have replaced the greedy pass's tokens). The
            # aligner always teacher-forces under the <|notimestamps|>
            # prompt on TEXT tokens only (openai find_alignment) — in
            # combined segments+words mode the decode ids carry timestamp
            # tokens that must be stripped first.
            ts_begin = cfg.no_timestamps_token_id + 1

            def _text_ids(b):
                ids = info[b]["ids"]
                return ([int(t) for t in ids if int(t) < ts_begin]
                        if timestamps else list(ids))
            aprompt = cfg.prompt_ids(language, task, no_timestamps=True)
            Pa = len(aprompt)
            width = Pa + max(len(_text_ids(b)) for b in kept) + 1
            buf = np.full((n, width), eos, np.int32)
            buf[:, :Pa] = aprompt
            for b in kept:
                ids = _text_ids(b)
                buf[b, Pa:Pa + len(ids)] = ids
            frames = [max(2, -(-len(c) // (2 * mel_ops.HOP_LENGTH)))
                      for c, _ in group]
            aligned = align_words(params, feats[:n], torch.from_numpy(buf), cfg,
                                  tokenizer, prompt_len=Pa, lora=lora,
                                  lora_scale=lora_scale, num_frames=frames)
            for b in kept:
                off = group[b][1]
                words.extend({"word": w["word"],
                              "start": round(w["start"] + off, 3),
                              "end": round(w["end"] + off, 3),
                              "probability": w["probability"]}
                             for w in aligned[b])
    text = " ".join(t.strip() for t in texts if t.strip())
    if word_timestamps and timestamps:
        return text, segments, words
    if word_timestamps:
        return text, words
    if timestamps:
        return text, segments
    return text


def _window_segment_words(params, feats, splits, cfg, tokenizer, *,
                          align_prompt, lora, lora_scale, chunk_len):
    """Align one window's timestamp-grammar segments and assign words to
    segments (openai add_word_timestamps): the window's concatenated TEXT
    tokens (timestamp tokens stripped — openai find_alignment) run through
    the DTW aligner under the <|notimestamps|> prompt, and each word lands
    in the segment containing its first token. Returns one word list per
    split, LOCAL clock."""
    from sar_tpu_torch.decode.align import align_words
    ts_begin = cfg.no_timestamps_token_id + 1
    text_per_seg = [[int(t) for t in toks if int(t) < ts_begin]
                    for _, _, toks in splits]
    flat = [t for toks in text_per_seg for t in toks]
    if not flat:
        return [[] for _ in splits]
    Pa = len(align_prompt)
    buf = np.full((1, Pa + len(flat) + 1), cfg.eos_token_id, np.int32)
    buf[0, :Pa] = align_prompt
    buf[0, Pa:Pa + len(flat)] = flat
    frames = [max(2, -(-chunk_len // (2 * mel_ops.HOP_LENGTH)))]
    rows, bounds = align_words(params, feats, torch.from_numpy(buf), cfg,
                               tokenizer, prompt_len=Pa, lora=lora,
                               lora_scale=lora_scale, num_frames=frames,
                               with_bounds=True)
    hi = np.cumsum([len(t) for t in text_per_seg])
    per_seg: list[list[dict]] = [[] for _ in splits]
    si = 0
    for w, (b0, _) in zip(rows[0], bounds[0]):
        while si < len(hi) - 1 and b0 >= hi[si]:
            si += 1
        per_seg[si].append(w)
    return per_seg


def _encode_prompt_text(tokenizer, text: str, cfg) -> list[int]:
    """Tokenize free text for the decoder context (no specials). HF
    tokenizers take add_special_tokens=False; the CharTokenizer surface
    (prompt + body + eos) is sliced instead."""
    try:
        return list(tokenizer.encode(" " + text.strip(),
                                     add_special_tokens=False))
    except TypeError:
        ids = list(tokenizer.encode(" " + text.strip()))
        return ids[len(cfg.prompt_ids("english")):-1]


def _transcribe_long_conditioned(
        audio, cfg, params, tokenizer, *, language, max_new_tokens,
        lora, lora_scale, fallback, no_speech_threshold, logprob_threshold,
        timestamps, word_timestamps, condition, initial_prompt,
        task="transcribe", best_of=1, chunk_seconds=30.0,
        overlap_seconds=0.0, timestamp_seek=True,
        carry_initial_prompt=False, temperatures=None,
        compression_ratio_threshold=2.4,
        hallucination_silence_threshold=None, device=None):
    """Sequential conditioned loop (see transcribe_long docstring)."""
    from sar_tpu_torch.evaluation.fallback import (FallbackTranscriber,
                                                   should_skip_silence)

    std = cfg.prompt_ids(language, task, no_timestamps=not timestamps)
    P_std = len(std)
    # Context budget: openai uses n_text_ctx//2 - 1 = 223; bounded by what
    # the target-position budget leaves after the prompt and new tokens.
    C = max(0, min(223, cfg.max_target_positions - P_std
                   - max_new_tokens - 1))
    width = P_std + (C + 1 if C else 0)
    transcriber = FallbackTranscriber(
        cfg, params, tokenizer, language=language,
        max_new_tokens=max_new_tokens, lora=lora, lora_scale=lora_scale,
        timestamps=timestamps, prompt_width=width, task=task,
        best_of=best_of, device=device,
        **({"logprob_threshold": logprob_threshold,
            "no_speech_threshold": no_speech_threshold,
            "compression_ratio_threshold": compression_ratio_threshold,
            **({"temperatures": temperatures} if temperatures else {})}
           if fallback
           else {"temperatures": temperatures or (0.0,),
                 "compression_ratio_threshold": None,
                 "logprob_threshold": None}))
    init_ids: list[int] = ([] if initial_prompt is None
                           else _encode_prompt_text(tokenizer, initial_prompt,
                                                    cfg)[-C:] if C else [])
    # openai's carry_initial_prompt: the initial prompt stays PINNED at the
    # front of every window's context — with OR without
    # condition_on_previous_text (openai pins it either way; only the
    # rolling previous-text part obeys the condition flag) — and survives
    # T>0.5 prompt resets. The rolling part trims to the remaining budget.
    carry: list[int] = init_ids if carry_initial_prompt else []
    ctx: list[int] = [] if carry else list(init_ids)
    ts_begin = cfg.no_timestamps_token_id + 1
    eos = cfg.eos_token_id
    texts: list[str] = []
    words: list[dict] = []
    segments: list[tuple] = []
    sr = mel_ops.SAMPLE_RATE
    win = int(chunk_seconds * sr)
    hop = win - int(overlap_seconds * sr)       # fixed-stride fallback
    if hop <= 0:
        raise ValueError("overlap must be smaller than the chunk size")
    seek_by_ts = timestamps and timestamp_seek
    audio = np.asarray(audio, np.float32)
    # openai's last_speech_timestamp: end of the last aligned word across
    # windows — the "silence before" anchor for the hallucination skip.
    last_speech_ts = 0.0
    astd = cfg.prompt_ids(language, task, no_timestamps=True)
    seek = 0
    while seek < len(audio):
        chunk = audio[seek:seek + win]
        if seek and len(chunk) < int(0.2 * sr):
            break                               # sub-200ms tail (chunker rule)
        off = seek / sr
        feats = window_features([chunk], cfg, device, params=params)
        keep = C - len(carry)
        pool = carry + (ctx[-keep:] if keep > 0 else [])
        if pool and C:
            ids = [cfg.prev_sot_token_id] + pool + std
        else:
            ids = list(std)
        buf = np.full((1, width), eos, np.int32)
        buf[0, :len(ids)] = ids
        (text,), (row,) = transcriber(feats, prompt=buf,
                                      prompt_len=len(ids))
        skipped = fallback and should_skip_silence(
            row, no_speech_threshold=no_speech_threshold,
            logprob_threshold=logprob_threshold)
        advance = min(hop, max(len(chunk), 1))
        kept_ids = row["ids"]
        if timestamps and not skipped:
            from sar_tpu_torch.decode.timestamps import split_segments
            splits = list(split_segments(row["ids"], cfg))
            # openai's window-advance rule: the window is consumed up to
            # the last CLOSED segment's end, and anything decoded after it
            # is dropped — its audio re-decodes in the next window. The
            # drop is taken ONLY together with the seek (dropping under a
            # fixed stride would lose that speech permanently). A window
            # with no closed segments keeps everything and consumes the
            # whole stride. A 1 s progress floor guards against
            # pathological near-zero timestamps stalling the loop (openai
            # has no such guard; real models always progress).
            closed = [i for i, s in enumerate(splits) if s[1] is not None]
            if seek_by_ts and closed:
                li = closed[-1]
                adv_s = splits[li][1]
                if adv_s >= 1.0:
                    advance = min(int(adv_s * sr), max(len(chunk), 1))
                    if li + 1 < len(splits):
                        splits = splits[:li + 1]
                        kept_ids = [t for _, _, toks in splits for t in toks]
                        text = tokenizer.decode(kept_ids)
        # Combined segments+words mode (openai's word path always runs
        # under the grammar): align the KEPT segments' text tokens, build
        # global-clock segment dicts with words, then apply openai's
        # word-level seek refinement and (optionally) the
        # hallucination-silence skip.
        drop_window = False
        seg_dicts = None
        if timestamps and word_timestamps and not skipped and kept_ids:
            from sar_tpu_torch.evaluation.hallucination import (
                get_end, is_segment_anomaly, next_words_segment)
            seg_words = _window_segment_words(
                params, feats, splits, cfg, tokenizer, align_prompt=astd,
                lora=lora, lora_scale=lora_scale, chunk_len=len(chunk))
            seg_dicts = []
            prev_end = 0.0
            for (t0, t1, toks), ws in zip(splits, seg_words):
                s0 = prev_end if t0 is None else t0
                s1 = max(s0, (len(chunk) / sr) if t1 is None else t1)
                prev_end = s1
                seg_dicts.append(
                    {"start": off + s0, "end": off + s1,
                     "words": [{**w, "start": round(w["start"] + off, 3),
                                "end": round(w["end"] + off, 3)}
                               for w in ws]})
            ids_l = [int(t) for t in row["ids"]]
            # openai's single_timestamp_ending: the decode ended on a lone
            # timestamp (no closed tail pair) — the whole window advances.
            single_ts_end = (len(ids_l) >= 2 and ids_l[-1] >= ts_begin
                             and ids_l[-2] < ts_begin)
            window_end = off + chunk_seconds
            thr = hallucination_silence_threshold
            if seek_by_ts and not single_ts_end:
                # Word-level seek refinement: consume up to the last
                # aligned word's end (a finer cut than the last closed
                # segment); under the hallucination threshold, a remaining
                # window shorter than thr is consumed whole instead.
                lwe = get_end(seg_dicts)
                if lwe is not None and lwe > off:
                    if thr is not None and window_end - lwe <= thr:
                        advance = max(len(chunk), 1)
                    elif lwe - off >= 1.0:
                        advance = min(int((lwe - off) * sr),
                                      max(len(chunk), 1))
            if thr is not None and seek_by_ts:
                first = next_words_segment(seg_dicts)
                if first is not None and is_segment_anomaly(first):
                    # Leading hallucination after a silent gap: skip the
                    # gap and re-decode from the suspect speech onset.
                    gap = first["start"] - off
                    if gap > thr:
                        advance = int(gap * sr)
                        drop_window = True
                if not drop_window:
                    # A hallucinated segment surrounded by silence (or by
                    # more hallucinations): emit everything before it,
                    # then seek to its start.
                    hal_last_end = last_speech_ts
                    cut = None
                    for si, seg in enumerate(seg_dicts):
                        if not seg["words"]:
                            continue
                        if is_segment_anomaly(seg):
                            nxt = next_words_segment(seg_dicts[si + 1:])
                            nxt_start = (nxt["words"][0]["start"] if nxt
                                         else off + len(chunk) / sr)
                            silence_before = (
                                seg["start"] - hal_last_end > thr
                                or seg["start"] < thr
                                or seg["start"] - off < 2.0)
                            silence_after = (
                                nxt_start - seg["end"] > thr
                                or is_segment_anomaly(nxt)
                                or window_end - seg["end"] < 2.0)
                            if silence_before and silence_after:
                                target = max(off + 1.0, seg["start"])
                                if len(audio) / sr - seg["end"] < thr:
                                    target = len(audio) / sr
                                advance = int(round((target - off) * sr))
                                cut = si
                                break
                        hal_last_end = seg["end"]
                    if cut is not None:
                        seg_dicts = seg_dicts[:cut]
                        splits = splits[:cut]
                        kept_ids = [t for _, _, toks in splits for t in toks]
                        text = tokenizer.decode(kept_ids)
            if not drop_window:
                wend = [w["end"] for s in seg_dicts for w in s["words"]]
                if wend:
                    last_speech_ts = wend[-1]
        if not skipped and not drop_window:
            texts.append(text)
            if timestamps:
                for t0, t1, toks in splits:
                    seg_text = tokenizer.decode(toks).strip()
                    if seg_text:
                        segments.append((
                            None if t0 is None else round(t0 + off, 2),
                            None if t1 is None else round(t1 + off, 2),
                            seg_text))
                if seg_dicts is not None:
                    words.extend(w for s in seg_dicts for w in s["words"])
            elif word_timestamps and row["ids"]:
                from sar_tpu_torch.decode.align import align_words
                # openai aligns WITHOUT the previous-text context (its
                # find_alignment prompt is the bare sot sequence).
                abuf = np.full((1, P_std + len(row["ids"]) + 1), eos,
                               np.int32)
                abuf[0, :P_std] = std
                abuf[0, P_std:P_std + len(row["ids"])] = row["ids"]
                frames = [max(2, -(-len(chunk) // (2 * mel_ops.HOP_LENGTH)))]
                aligned = align_words(params, feats, torch.from_numpy(abuf), cfg,
                                      tokenizer, prompt_len=P_std, lora=lora,
                                      lora_scale=lora_scale,
                                      num_frames=frames)[0]
                words.extend({"word": w["word"],
                              "start": round(w["start"] + off, 3),
                              "end": round(w["end"] + off, 3),
                              "probability": w["probability"]}
                             for w in aligned)
        # openai's prompt-reset rule: sampled-at-high-temperature windows
        # poison the context; skipped (silent) and hallucination-dropped
        # windows contribute nothing (openai `continue`s past the update).
        if condition and not drop_window:
            if row["temperature"] > 0.5:
                ctx = []
            elif not skipped:
                new = kept_ids
                if timestamps:
                    new = [t for t in new if t < ts_begin]
                ctx.extend(int(t) for t in new)
                ctx = ctx[-C:] if C else []
        elif not condition:
            ctx = []        # initial_prompt conditions the FIRST window only
        seek += max(int(advance), 1)
    text = " ".join(t.strip() for t in texts if t.strip())
    if word_timestamps and timestamps:
        return text, segments, words
    if word_timestamps:
        return text, words
    if timestamps:
        return text, segments
    return text
