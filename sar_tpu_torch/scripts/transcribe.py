"""Transcribe audio files from the command line.

    python -m sar_tpu_torch.scripts.transcribe clip.wav --model whisper-test \\
        --language english --max_new_tokens 8 --device cpu

The port of scripts/transcribe.py, with its flags and modes; `--device`
takes the place of `--platform` (default: the CUDA card).

- default: one 30 s window, greedy over the unquantized classic cache
  (evaluator.transcribe_audio);
- `--num_beams N` / `--length_penalty`: beam search;
- `--timestamps`: the timestamp grammar, '[start -> end] text' segments;
- `--word_timestamps`: per-word times by cross-attention DTW;
- `--fallback` (`--temperature`, `--best_of`, the thresholds): openai's
  temperature ladder; `--temperature` alone is one sampled pass;
- `--longform` (automatic past 30 s; `--chunk_seconds`,
  `--overlap_seconds`, `--clip_timestamps`): chunked transcription;
- `--condition_on_previous_text`, `--initial_prompt`,
  `--carry_initial_prompt`, `--hallucination_silence_threshold`: the
  sequential conditioned long-form loop;
- `--streaming` (`--stream_chunk_seconds`): the file fed to a
  StreamingTranscriber chunk by chunk, the committed transcript printed as
  it grows (it takes precedence over long-form and the single window);
- `--language auto`: zero-shot language detection by the base model;
- `--task translate`, `--checkpoint` (a LoRA adapter directory),
  `--output` ({file: text} JSON), `--output_format`/`--output_dir`
  (txt/json/srt/vtt/tsv per input).

The single-window beam, timestamp and word paths run, as the JAX
script's, the exact encoder and the unquantized classic cache (no decode
kernel); the fallback path and the long-form extras run the
FallbackTranscriber (kernels K1, K2 and K3 on the card); streaming runs
K1 and the unquantized cache. Every decode loop replays captured CUDA
graphs on the card; the default path keeps one program for every file
(evaluator.plain_evaluator).

`run` is the part after the base model, the tokenizer and the adapter are
loaded, for in-process callers that bring their own (`main` loads them
with `load_base_model`, `get_tokenizer` and `load_any_adapter`).
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import torch

from sar_tpu_torch.data import get_tokenizer
from sar_tpu_torch.data.preprocessing import load_audio
from sar_tpu_torch.decode.align import align_words
from sar_tpu_torch.decode.graphs import CudaGraphCapture, DecodeRunner, resolve_capture
from sar_tpu_torch.decode.greedy import transcribe_tokens
from sar_tpu_torch.decode.timestamps import format_segments, split_segments
from sar_tpu_torch.device import resolve_device, tree_to
from sar_tpu_torch.evaluation import writers
from sar_tpu_torch.evaluation.evaluator import transcribe_audio
from sar_tpu_torch.evaluation.fallback import transcribe_batch_with_fallback
from sar_tpu_torch.evaluation.longform import transcribe_long, window_features
from sar_tpu_torch.evaluation.streaming import StreamingTranscriber
from sar_tpu_torch.models import lora as lora_lib
from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.base import load_base_model
from sar_tpu_torch.models.config import WHISPER_LANGUAGES
from sar_tpu_torch.ops import mel as mel_ops

logger = logging.getLogger("transcribe")

# Flags of the JAX script the port replaces.
NOT_PORTED = {"--platform": "use --device"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Transcribe audio files (PyTorch port)")
    p.add_argument("audio", nargs="+", help="Audio files (wav)")
    p.add_argument("--model", type=str, default="whisper-small")
    p.add_argument("--language", type=str, default="hindi",
                   help='Language name/code, or "auto" for zero-shot '
                        "detection from the model's <|lang|> distribution "
                        "(needs real multilingual weights)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="LoRA adapter dir (train_lora output, or PEFT)")
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--task", type=str, default="transcribe",
                   choices=["transcribe", "translate"])
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--length_penalty", type=float, default=1.0)
    p.add_argument("--temperature", type=float, default=0.0,
                   help="With --fallback the start of the ladder (T, T+0.2, "
                        ".. 1.0); alone, one sampled pass at T")
    p.add_argument("--compression_ratio_threshold", type=float, default=2.4)
    p.add_argument("--logprob_threshold", type=float, default=-1.0)
    p.add_argument("--no_speech_threshold", type=float, default=0.6)
    p.add_argument("--timestamps", action="store_true",
                   help="Decode with the timestamp grammar; print segments")
    p.add_argument("--word_timestamps", action="store_true",
                   help="Per-word times by cross-attention DTW")
    p.add_argument("--hallucination_silence_threshold", type=float, default=None,
                   help="Seconds of silence to skip around a suspected "
                        "hallucination (implies --timestamps, "
                        "--word_timestamps and the sequential loop)")
    p.add_argument("--fallback", action="store_true",
                   help="openai-style temperature fallback")
    p.add_argument("--best_of", type=int, default=1,
                   help="Sampled candidates per fallback pass at T > 0")
    p.add_argument("--longform", action="store_true",
                   help="Chunked transcription (automatic past 30 s)")
    p.add_argument("--chunk_seconds", type=float, default=30.0)
    p.add_argument("--clip_timestamps", type=str, default=None,
                   help='"start,end,start,end,..." seconds to transcribe; '
                        "times stay on the file's clock")
    p.add_argument("--overlap_seconds", type=float, default=0.0)
    p.add_argument("--condition_on_previous_text", action="store_true")
    p.add_argument("--initial_prompt", type=str, default=None)
    p.add_argument("--carry_initial_prompt", action="store_true")
    p.add_argument("--streaming", action="store_true",
                   help="Simulate a live stream from the file; print the "
                        "committed transcript as it grows")
    p.add_argument("--stream_chunk_seconds", type=float, default=1.0)
    p.add_argument("--output", type=str, default=None,
                   help="Write {file: transcript} JSON here")
    p.add_argument("--output_format", type=str, default=None,
                   choices=["txt", "json", "srt", "vtt", "tsv"],
                   help="Write <audio stem>.<fmt> per input; srt/vtt/tsv "
                        "imply --timestamps")
    p.add_argument("--output_dir", type=str, default=".")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    for flag in NOT_PORTED:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    for flag, why in NOT_PORTED.items():
        if getattr(args, flag[2:]) is not None:
            p.error(f"{flag}: not in sar_tpu_torch: {why}")
    return args


def _temperatures(args):
    """openai's ladder with --fallback (T, T+0.2, .. 1.0); --temperature
    alone is one sampled pass; None for plain greedy."""
    if args.fallback:
        temps, t = [], args.temperature
        while t < 1.0 + 1e-6:
            temps.append(round(t, 2))
            t += 0.2
        return tuple(temps) or (args.temperature,)
    if args.temperature > 0:
        return (args.temperature,)
    return None


def _run_long(audio, cfg, params, tokenizer, language, lora, lora_scale, args,
              temps, device):
    """One long-form engine call with every CLI knob applied."""
    return transcribe_long(
        audio, cfg, params, tokenizer, language=language,
        max_new_tokens=args.max_new_tokens, chunk_seconds=args.chunk_seconds,
        overlap_seconds=args.overlap_seconds, lora=lora, lora_scale=lora_scale,
        fallback=args.fallback, word_timestamps=args.word_timestamps,
        timestamps=args.timestamps,
        hallucination_silence_threshold=args.hallucination_silence_threshold,
        condition_on_previous_text=args.condition_on_previous_text,
        initial_prompt=args.initial_prompt, task=args.task, best_of=args.best_of,
        carry_initial_prompt=args.carry_initial_prompt, temperatures=temps,
        no_speech_threshold=args.no_speech_threshold,
        logprob_threshold=args.logprob_threshold,
        compression_ratio_threshold=args.compression_ratio_threshold,
        device=device)


def _long(audio, seconds, clips, cfg, params, tokenizer, language, lora,
          lora_scale, args, temps, device):
    """(text, segments, words) of the long-form engine over the clip
    ranges (the whole file by default), times on the file's clock."""
    texts_acc, segs_acc, words_acc = [], [], []
    for c0, c1 in (clips or [(0.0, seconds)]):
        piece = audio[int(c0 * mel_ops.SAMPLE_RATE):int(c1 * mel_ops.SAMPLE_RATE)]
        out = _run_long(piece, cfg, params, tokenizer, language, lora, lora_scale,
                        args, temps, device)
        if args.word_timestamps and args.timestamps:
            t, segs, ws = out
        elif args.word_timestamps:
            (t, ws), segs = out, None
        elif args.timestamps:
            (t, segs), ws = out, None
        else:
            t, segs, ws = out, None, None
        if ws is not None:
            words_acc.extend({**w, "start": round(w["start"] + c0, 3),
                              "end": round(w["end"] + c0, 3)} for w in ws)
        if segs is not None:
            segs_acc.extend((None if a is None else round(a + c0, 2),
                             None if z is None else round(z + c0, 2), txt)
                            for a, z, txt in segs)
        texts_acc.append(t)
    text = " ".join(t.strip() for t in texts_acc if t.strip())
    segments = words = None
    if args.timestamps:
        segments = segs_acc
        for s0, s1, seg_text in segs_acc:
            a = "?" if s0 is None else f"{s0:7.2f}"
            z = "?" if s1 is None else f"{s1:7.2f}"
            print(f"[{a} -> {z}] {seg_text}")
    if args.word_timestamps:
        words = words_acc
        if not args.timestamps:
            print(text)
        for w in words_acc:
            print(f"[{w['start']:7.2f} -> {w['end']:7.2f}] {w['word']}")
    if not args.timestamps and not args.word_timestamps:
        print(text)
    return text, segments, words


def _single_window(audio, runner, cfg, params, tokenizer, language, lora,
                   lora_scale, args, device):
    """(text, segments, words) of one window by beam search or greedy over
    the unquantized classic cache, with the timestamp grammar or the word
    aligner."""
    feats = window_features([audio], cfg, device, params=params)
    with torch.no_grad():
        enc = whisper.encode(params, feats, cfg, lora=lora, lora_scale=lora_scale)
    # --timestamps drops <|notimestamps|> from the prompt and turns on the
    # grammar inside the loop.
    prompt = cfg.prompt_ids(language, args.task, no_timestamps=not args.timestamps)
    P = len(prompt)
    total = min(P + args.max_new_tokens, cfg.max_target_positions)
    if args.num_beams > 1:
        cache = runner.prep(enc, total, self_batch=enc.shape[0] * args.num_beams)
        tokens = runner.beam(cache, prompt, num_beams=args.num_beams,
                             length_penalty=args.length_penalty,
                             timestamps=args.timestamps)
    else:
        tokens = runner.greedy(runner.prep(enc, total), prompt,
                               timestamps=args.timestamps)
    ids = transcribe_tokens(tokens, cfg, prompt_len=P)
    segments = words = None
    if args.timestamps:
        raw = split_segments(ids[0], cfg)
        text = format_segments(raw, tokenizer)
        decoded = ((a, z, tokenizer.decode(toks).strip()) for a, z, toks in raw)
        segments = [seg for seg in decoded if seg[2]]
    else:
        text = tokenizer.decode(ids[0])
    print(text)
    if args.word_timestamps and not args.timestamps:
        n_frames = min(-(-len(audio) // (2 * mel_ops.HOP_LENGTH)),
                       cfg.max_source_positions)
        words = align_words(params, feats, tokens, cfg, tokenizer, prompt_len=P,
                            lora=lora, lora_scale=lora_scale, enc_out=enc,
                            num_frames=[n_frames])[0]
        for w in words:
            print(f"[{w['start']:6.2f} -> {w['end']:6.2f}] {w['word']}")
    return text, segments, words


def _stream(st: StreamingTranscriber, audio, args) -> str:
    """Feed the file to `st` in --stream_chunk_seconds chunks, printing
    the committed transcript as it grows; returns the final text."""
    st.reset()
    step = int(args.stream_chunk_seconds * mel_ops.SAMPLE_RATE)
    shown = ""

    def show(text):
        # Committed ids never retract, but their decoded string can be
        # revised at a boundary (a partial UTF-8 sequence completing):
        # reprint the line when it is not an append.
        nonlocal shown
        if text == shown:
            return
        if text.startswith(shown):
            print(text[len(shown):], end="", flush=True)
        else:
            print("\r" + text, end="", flush=True)
        shown = text

    for s in range(0, len(audio), step):
        show(st.feed(audio[s:s + step]))
    text = st.finalize()
    show(text)
    print()
    return text


def _detect_language(audio, cfg, params, device) -> str:
    """--language auto: the base model's <|lang|> distribution (the
    decoder pass has no adapter, so the encoder runs without one too)."""
    with torch.no_grad():
        enc0 = whisper.encode(params, window_features([audio], cfg, device, params=params), cfg)
        idx, probs = whisper.detect_language(params, enc0, cfg)
    language = WHISPER_LANGUAGES[int(idx[0])]
    logger.info("detected language: %s (p=%.2f)", language,
                float(probs[0, int(idx[0])]))
    return language


def run(args, cfg, params, tokenizer, lora=None, lora_scale: float = 1.0,
        device=None) -> dict:
    """Transcribe every file of `args.audio` with the model given (params
    on any device, moved to `device` once; `lora` a bank whose adapter 0
    is used) and write the outputs asked for; returns {file: text}."""

    device = resolve_device(device)
    params = tree_to(params, device)
    if lora is not None:
        lora = tree_to(lora, device, params["encoder"]["conv1"]["w"].dtype)
    # The single-window decodes share one runner: a second file of the
    # same shape replays the first one's captured loop.
    runner = DecodeRunner(params, cfg, lora=lora, lora_scale=lora_scale,
                          capture=(CudaGraphCapture
                                   if resolve_capture(None, device) else None))
    # One streaming transcriber, built again when the language changes: a
    # later file in the same language replays its captured program.
    stream, stream_language = None, None
    results = {}
    for path in args.audio:
        audio = load_audio(path)
        seconds = len(audio) / mel_ops.SAMPLE_RATE
        language = args.language
        if language == "auto":
            language = _detect_language(audio, cfg, params, device)
        conditioned = (args.condition_on_previous_text
                       or args.initial_prompt is not None
                       or args.hallucination_silence_threshold is not None)
        if args.hallucination_silence_threshold is not None:
            # openai's heuristics score per-segment words inside the seek
            # loop: they imply both timestamp modes.
            if not (args.timestamps and args.word_timestamps):
                logger.info("--hallucination_silence_threshold implies "
                            "--timestamps and --word_timestamps; enabling")
            args.timestamps = args.word_timestamps = True
        clips = None
        if args.clip_timestamps:
            vals = [float(v) for v in args.clip_timestamps.split(",") if v]
            if len(vals) % 2:
                vals.append(seconds)
            clips = list(zip(vals[::2], vals[1::2]))
            if any(e <= s0 for s0, e in clips):
                raise SystemExit("--clip_timestamps ranges must be start < end")
        if (args.output_format in writers.SEGMENT_FORMATS and not args.timestamps
                and not args.streaming):
            logger.info("--output_format %s needs segments; enabling "
                        "--timestamps", args.output_format)
            args.timestamps = True
        if args.carry_initial_prompt and args.initial_prompt is None:
            logger.warning("--carry_initial_prompt needs --initial_prompt; ignored")
        if args.best_of > 1 and not args.fallback and args.temperature == 0:
            logger.warning("--best_of applies to sampled passes; ignored "
                           "without --fallback or --temperature > 0")
        # Conditioning and clip ranges ride the long-form engine (a short
        # clip is one window there); streaming goes first.
        long = (args.longform or seconds > mel_ops.CHUNK_SECONDS
                or ((conditioned or clips is not None) and not args.streaming))
        if clips is not None and args.streaming:
            logger.warning("--clip_timestamps does not apply to streaming; ignored")
        if conditioned and args.streaming:
            logger.warning("--condition_on_previous_text/--initial_prompt "
                           "do not apply to streaming; ignored")
        # The conflict warnings follow the dispatch below: each names the
        # flag that this path drops.
        if args.streaming:
            for flag, on in [("--num_beams", args.num_beams > 1),
                             ("--timestamps", args.timestamps),
                             ("--word_timestamps", args.word_timestamps),
                             ("--fallback", args.fallback),
                             ("--temperature", args.temperature > 0)]:
                if on:
                    logger.warning("%s does not apply to streaming; ignored", flag)
        elif long:
            if args.num_beams > 1:
                logger.warning("--num_beams only applies to single-window "
                               "decoding; long-form uses greedy")
        else:
            if (args.fallback or args.temperature > 0) and (
                    args.num_beams > 1 or args.timestamps or args.word_timestamps):
                logger.warning("--fallback/--temperature are greedy "
                               "plain-text only in single-window mode; "
                               "ignored here")
            if args.timestamps and args.word_timestamps:
                logger.warning("--timestamps and --word_timestamps are "
                               "exclusive; emitting segments "
                               "(--word_timestamps ignored)")
        temps = _temperatures(args)
        segments = words = None
        t0 = time.perf_counter()
        if args.streaming:
            if stream_language != language:
                stream = None                   # its cache and graphs go first
                stream = StreamingTranscriber(
                    cfg, params, tokenizer, language=language,
                    max_new_tokens=args.max_new_tokens, lora=lora,
                    lora_scale=lora_scale, task=args.task, device=device)
                stream_language = language
            text = _stream(stream, audio, args)
        elif long:
            text, segments, words = _long(audio, seconds, clips, cfg, params,
                                          tokenizer, language, lora, lora_scale,
                                          args, temps, device)
        elif args.num_beams > 1 or args.timestamps or args.word_timestamps:
            text, segments, words = _single_window(
                audio, runner, cfg, params, tokenizer, language, lora,
                lora_scale, args, device)
        elif args.fallback or args.temperature > 0:
            # --temperature alone is pure sampling (no quality gates).
            (text,), (row,) = transcribe_batch_with_fallback(
                cfg, params, window_features([audio], cfg, device, params=params), tokenizer,
                language=language, max_new_tokens=args.max_new_tokens,
                lora=lora, lora_scale=lora_scale, task=args.task,
                best_of=args.best_of, temperatures=temps,
                compression_ratio_threshold=(args.compression_ratio_threshold
                                             if args.fallback else None),
                logprob_threshold=args.logprob_threshold if args.fallback else None,
                no_speech_threshold=(args.no_speech_threshold
                                     if args.fallback else None),
                device=device)
            logger.info("accepted at T=%.1f (avg_logprob %.3f, compression "
                        "%.2f)", row["temperature"], row["avg_logprob"],
                        row["compression_ratio"])
            print(text)
        else:
            text = transcribe_audio(audio, cfg, params, tokenizer, language=language,
                                    max_new_tokens=args.max_new_tokens, lora=lora,
                                    lora_scale=lora_scale, task=args.task,
                                    device=device)
            print(text)
        dt = time.perf_counter() - t0
        logger.info("%s: %.1f s audio in %.2f s (%.1fx real-time)", path,
                    seconds, dt, seconds / max(dt, 1e-9))
        results[path] = text
        if args.output_format:
            if args.output_format in writers.SEGMENT_FORMATS and segments is None:
                logger.warning("%s: no segments on this path; %s output will "
                               "be empty of cues", path, args.output_format)
            out_dir = Path(args.output_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
            dst = out_dir / (Path(path).stem + "." + args.output_format)
            dst.write_text(writers.render(args.output_format, text,
                                          segments=segments, words=words))
            logger.info("wrote %s", dst)
    if args.output:
        Path(args.output).write_text(json.dumps(results, indent=2,
                                                ensure_ascii=False))
        logger.info("wrote %s", args.output)
    return results


def main(argv=None) -> dict:
    args = parse_args(argv)

    device = resolve_device(args.device)
    cfg, params = load_base_model(args.model, dtype=torch.bfloat16, device=device)
    tokenizer = get_tokenizer(
        args.model, language="english" if args.language == "auto" else args.language)
    lora, lora_scale = None, 1.0
    if args.checkpoint:
        ckpt = Path(args.checkpoint)
        adapter = ckpt / "adapter" if (ckpt / "adapter").exists() else ckpt
        lora, lcfg, _ = lora_lib.load_any_adapter(adapter, cfg, device)
        lora_scale = lcfg.scale
        logger.info("adapter %s (r=%d alpha=%d)", adapter, lcfg.r, lcfg.alpha)
    return run(args, cfg, params, tokenizer, lora, lora_scale, device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
