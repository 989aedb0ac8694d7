"""Benchmark CLI: RTFx sweeps across model, batch, cache, scores and beam
width, and the train, routed and serving rows.

    python -m sar_tpu_torch.scripts.benchmark --model whisper-small \\
        --batch_sizes 8 32 --kv_cache int8 bf16 --num_beams 1 4 \\
        --max_new_tokens 256 --output chiprun_out/bench.json

The port of scripts/benchmark.py, with its flags, defaults, rows and row
keys, plus `--device` (default: the CUDA card). Weights are random, from
`get_config` and a seeded generator (throughput does not depend on their
values); no checkpoint is read. The rows:

- config rows (the default): mel -> encode -> the cache (`--kv_cache`
  int8 | bf16 | int4, `--kv_layout` auto | classic) -> greedy, or beam
  search for `--num_beams` > 1; `--attn_scores int8` takes the int8 rows
  to s8 scores. Agreement keys, each against a decode over the int8
  classic layout, as the JAX CLI takes them: `token_agreement_vs_classic`
  (int8 head-minor greedy), `_vs_bf16` (s8 greedy) and `_vs_int8` (int4
  greedy); `--no_agreement` skips them;
- `--train`: `ASRTrainer.train_step` over `--train_accum` microbatches of
  random mel and labels, in examples/s;
- `--routed`: LID at `--routed_lid_layer` -> the bank gather -> the
  adapted encoder, cache and greedy decode (`AdapterRouter`), against the
  oracle decode given the same adapter indices; routing overhead and LID
  ms per utterance, and the token agreement with the oracle;
- `--serving`: `--serving_requests` clips pushed from as many client
  threads through a `TranscriptionService`;
- `--streaming`: per-update latency of a `StreamingTranscriber` (batch 1)
  fed `--streaming_chunk_seconds` of audio per update, one row per
  `--kv_cache` (int8: the int8 head-minor cache; else the unquantized
  one, labelled bf16 as in the JAX CLI).

The config and routed rows time the decode programs users run: a
`DecodeRunner` (decode/graphs.py, the evaluator's and the router's), whose
greedy or beam loop replays one captured CUDA graph per segment, as the
JAX CLI times `jax.jit` programs. `--capture` auto (the default) captures
on the card and runs eagerly on the CPU; off times the eager loop, on
requires the card. The capture happens in the warm-up call, so the timed
iterations are replays; its cost is printed on a line of its own.

Every timed region is fenced by a CUDA sync on both sides;
`seconds_per_batch` (`s_per_step`, `routed_s_per_batch`, ...) is the mean
over `--iters` iterations after one warm-up, and each row also carries its
per-iteration walls (`iter_s`). A config row that runs out of device
memory is recorded as {"batch": b, ..., "error": "oom"} (capacity probes);
any other error propagates. Each streaming update is fenced the same
way. `--dp/--tp/--dcn_dp` run the config and train rows on a device mesh,
one process per device (`torchrun --nproc_per_node N -m
sar_tpu_torch.scripts.benchmark ...`): each rank runs its rows of every
batch (the decode over a classic cache, eager where the "model" axis has
more than one rank), and the rates are of the whole batch; as in the JAX
CLI, `--attn_scores int8` falls back to bf16 scores there, and the routed,
serving and streaming rows run the single-device program, ignoring the
mesh. `--platform` is refused. `--output` (rank 0) writes the report.
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
import time
from pathlib import Path

import numpy as np
import torch

from sar_tpu_torch.utils.profiling import Timer

logger = logging.getLogger("benchmark")

LANGUAGES = ["hindi", "italian", "punjabi", "telugu", "german", "french",
             "spanish", "english"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="RTFx benchmark sweeps (PyTorch port)")
    p.add_argument("--model", type=str, default="whisper-small")
    p.add_argument("--batch_sizes", type=int, nargs="+", default=[32, 128])
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--kv_cache", type=str, nargs="+", default=["int8"],
                   choices=["int8", "bf16", "int4"])
    p.add_argument("--kv_layout", type=str, default="auto",
                   choices=["auto", "classic"],
                   help="Cross-KV cache layout of the int8 cache: auto = "
                        "whisper.use_head_minor (the head-minor slabs that "
                        "kernels K3/K5/K7 stream), classic = the "
                        "[L,B,H,S,hd] layout in plain torch")
    p.add_argument("--attn_scores", type=str, default="bf16",
                   choices=["bf16", "int8"],
                   help="int8: s8 query and probabilities in the decode's "
                        "attention (kernel K7 on the card; approximate); "
                        "requires int8 KV; reports token agreement vs bf16")
    p.add_argument("--num_beams", type=int, nargs="+", default=[1],
                   help="Beam widths to sweep (1 = greedy)")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--platform", type=str, default="auto",
                   choices=["auto", "cpu", "tpu"], help="not ported: use --device")
    p.add_argument("--dp", type=int, default=1,
                   help="Data-parallel mesh axis (batch shards over it); "
                        "one process per device, launched with torchrun")
    p.add_argument("--tp", type=int, default=1,
                   help="Tensor-parallel mesh axis (attention heads / FFN "
                        "split over it; must divide the heads)")
    p.add_argument("--dcn_dp", type=int, default=1,
                   help="Data-parallel replicas across nodes (adds a leading "
                        "'replica' mesh axis)")
    p.add_argument("--streaming", action="store_true",
                   help="Per-update latency of the streaming transcriber "
                        "(batch 1; one row per --kv_cache)")
    p.add_argument("--streaming_chunk_seconds", type=float, default=1.0,
                   help="Audio fed per streaming update (with --streaming)")
    p.add_argument("--train", action="store_true",
                   help="Benchmark the LoRA train step (forward + backward + "
                        "AdamW, gradient accumulation) in examples/s")
    p.add_argument("--train_accum", type=int, default=4,
                   help="Gradient accumulation microbatches per step")
    p.add_argument("--train_label_len", type=int, default=224,
                   help="Label length per example (448 max positions)")
    p.add_argument("--train_lora_rank", type=int, default=16)
    p.add_argument("--train_remat", type=str, default="on", choices=["on", "off"],
                   help="Gradient checkpointing in the train step")
    p.add_argument("--routed", action="store_true",
                   help="Benchmark Phase-2 routed inference: LID -> bank "
                        "gather -> decode per mixed-language batch vs the "
                        "oracle-language decode; routing overhead per "
                        "utterance (the reference's target: < 10 ms/utt)")
    p.add_argument("--routed_languages", type=int, default=4,
                   help="Adapters in the routed bank")
    p.add_argument("--routed_lid_layer", type=int, default=-1,
                   help="Encoder layer tapped for LID features (-1 = final "
                        "post-LN output; k >= 0 runs only the first k+1 layers)")
    p.add_argument("--routed_lora_rank", type=int, default=16)
    p.add_argument("--serving", action="store_true",
                   help="Benchmark the micro-batching service at saturation "
                        "(concurrent clients, latency including queueing)")
    p.add_argument("--serving_requests", type=int, default=128,
                   help="Concurrent requests per serving row")
    p.add_argument("--serving_wait_ms", type=float, default=20.0,
                   help="Service batching window")
    p.add_argument("--no_agreement", action="store_true",
                   help="Skip the token-agreement comparison decode of the "
                        "config rows (capacity probes)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--capture", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="Decode loop as captured CUDA graphs (auto: on the "
                        "card) or eager (off)")
    p.add_argument("--output", type=str, default=None)
    args = p.parse_args(argv)
    if args.platform != "auto":
        p.error(f"--platform {args.platform}: not ported to sar_tpu_torch "
                f"(use --device)")
    return args


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def timed(fn, iters: int):
    """fn() once to warm up, then `iters` fenced calls -> (mean seconds,
    per-iteration seconds, the last call's result)."""
    (mean, walls, out), = timed_rounds([fn], iters)
    return mean, walls, out


def timed_rounds(fns, iters: int):
    """Each fn once to warm up, then `iters` rounds that call every fn once
    in turn, each call fenced by a CUDA sync (`profiling.Timer`) ->
    [(mean seconds, per-iteration seconds, the last call's result)] per
    fn. Interleaving spreads the host's drift over the fns compared with
    one another."""
    outs = [fn() for fn in fns]
    walls = [[] for _ in fns]
    for _ in range(iters):
        for i, fn in enumerate(fns):
            with Timer() as t:
                outs[i] = fn()
            walls[i].append(t.elapsed)
    return [(sum(w) / len(w), [round(x, 4) for x in w], o) for w, o in zip(walls, outs)]


def _audio(batch: int, device: torch.device) -> torch.Tensor:
    from sar_tpu_torch.ops import mel as mel_ops
    rng = np.random.default_rng(0)
    return torch.from_numpy((rng.standard_normal((batch, mel_ops.N_SAMPLES)) * 0.1)
                            .astype(np.float32)).to(device)


def _mel(cfg, params, audio: torch.Tensor) -> torch.Tensor:
    from sar_tpu_torch.models import frontend
    return frontend.features(audio, cfg, params, dtype=torch.bfloat16,
                             device=audio.device)


def _agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    return round(float((a == b).float().mean()), 4)


# ---------------------------------------------------------------------------
# Rows
# ---------------------------------------------------------------------------

def run_serving(cfg, params, batch, max_new_tokens, n_requests, max_wait_ms,
                device, capture=None):
    """Saturation throughput and latency of the micro-batching service:
    n_requests client threads push one window-length clip each through a
    TranscriptionService; latency includes queueing. `compile_s` is the
    first request's wall (the warm-up)."""
    from sar_tpu_torch.data import CharTokenizer
    from sar_tpu_torch.serving import TranscriptionService

    window_s = cfg.num_audio_frames / 100.0        # mel hop = 10 ms
    rng = np.random.default_rng(0)
    clips = [(rng.standard_normal(int(window_s * 16000)) * 0.1).astype(np.float32)
             for _ in range(8)]
    svc = TranscriptionService(cfg, params, CharTokenizer(cfg), language="hindi",
                               batch_size=batch, max_wait_ms=max_wait_ms,
                               max_new_tokens=max_new_tokens, device=device,
                               capture=capture)
    try:
        t0 = time.perf_counter()
        svc.transcribe(clips[0], timeout=1800)
        compile_s = time.perf_counter() - t0
        results = [None] * n_requests

        def run(i):
            results[i] = svc.transcribe(clips[i % len(clips)], timeout=1800)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(n_requests)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        st = svc.stats()
    finally:
        svc.close()
    if not all(isinstance(r, str) for r in results):
        raise RuntimeError("serving: a request returned no transcript")
    return {"mode": "serving", "batch": batch, "requests": n_requests,
            "wall_s": round(dt, 2),
            "requests_per_s": round(n_requests / dt, 2),
            "audio_sec_per_s": round(n_requests * window_s / dt, 1),
            "batches": st["batches"] - 1,          # minus the warm-up
            "latency_ms_p50": st.get("latency_ms_p50"),
            "latency_ms_p95": st.get("latency_ms_p95"),
            "compile_s": round(compile_s, 1),
            "iter_s": [round(dt, 4)]}


def run_streaming(cfg, params, chunk_seconds, iters, kv_int8, max_new_tokens,
                  device, capture=None):
    """Per-update latency of a StreamingTranscriber (batch 1): real time
    while an update takes less than `chunk_seconds` (rtf > 1). Every update
    re-encodes the window and replays the committed transcript through one
    captured decode program (the forced prefix length refilled per call).
    One warm-up update (the capture), then `iters` windows of
    updates_per_window updates, each fenced."""
    from sar_tpu_torch.data import CharTokenizer
    from sar_tpu_torch.evaluation.streaming import StreamingTranscriber
    from sar_tpu_torch.ops import mel as mel_ops

    st = StreamingTranscriber(cfg, params, CharTokenizer(cfg), language="hindi",
                              max_new_tokens=max_new_tokens, kv_int8=kv_int8,
                              device=device, capture=capture)
    rng = np.random.default_rng(0)
    chunk_n = int(chunk_seconds * mel_ops.SAMPLE_RATE)
    updates = max(1, st.window_samples // chunk_n)

    def chunk():
        return (rng.standard_normal(chunk_n) * 0.1).astype(np.float32)

    st.feed(chunk())                        # the capture, and a warm-up
    lats = []
    for _ in range(iters):
        st.reset()
        for _ in range(updates):
            with Timer() as t:
                st.feed(chunk())
            lats.append(t.elapsed)
    _print_capture(f"streaming kv={'int8' if kv_int8 else 'bf16'}", st.runner)
    lats = sorted(lats)
    mean = sum(lats) / len(lats)
    p90 = lats[int(0.9 * (len(lats) - 1))]
    return {"mode": "streaming", "chunk_seconds": chunk_seconds,
            "updates_per_window": updates,
            "ms_per_update_mean": round(mean * 1000, 2),
            "ms_per_update_p90": round(p90 * 1000, 2),
            "streaming_rtf": round(chunk_seconds / mean, 2),
            "kv": "int8" if kv_int8 else "bf16"}


def _print_capture(label: str, runner) -> None:
    st = runner.graph_stats()
    if st["graphs"]:
        print(f"capture {label}: {st['graphs']} graphs, {st['nodes']} nodes, "
              f"{st['capture_s']:.3f} s to capture and instantiate (outside "
              f"the timed iterations)")


def run_routed(cfg, params, batch, max_new_tokens, iters, kv, n_languages,
               lid_layer, lora_rank, device, capture=None):
    """Phase-2 routed inference: mel -> LID features at `lid_layer` ->
    classifier -> adapter index -> the adapted encoder, cache (K4's cross_v
    term on the int8 cache) and greedy decode, against the ORACLE decode
    (the same banked decode, the indices given), so the routing overhead
    (the LID pass, the classifier and the gathers) is isolated per
    utterance. Both decodes replay the router's captured programs (one
    key: the same shapes); every timed region is fenced on both sides, and
    the three are timed in interleaved rounds (routed, oracle, LID), since
    the host's walls drift between runs. Weights, bank and head are random:
    throughput does not depend on their values."""
    from sar_tpu_torch.models import classifier as clf
    from sar_tpu_torch.models import lora as lora_lib
    from sar_tpu_torch.models.router import AdapterRouter
    from sar_tpu_torch.ops import mel as mel_ops

    langs = LANGUAGES[:n_languages]
    lcfg = lora_lib.LoraConfig(r=lora_rank, alpha=2 * lora_rank)
    bank = lora_lib.init_lora(torch.Generator().manual_seed(0), cfg, lcfg,
                              num_adapters=n_languages)
    ccfg = clf.ClassifierConfig(input_dim=cfg.d_model, dropout=0.0,
                                num_classes=n_languages, languages=tuple(langs),
                                encoder_layer=lid_layer)
    clf_params = clf.init_classifier(torch.Generator().manual_seed(42), ccfg)
    router = AdapterRouter(cfg, params, bank, lcfg, clf_params, ccfg, device=device,
                           capture=capture)
    kv_int8, kv_int4 = kv == "int8", kv == "int4"
    audio = _audio(batch, device)

    def lid_only():
        return router.route(_mel(cfg, params, audio))[0]

    def decode(feats, idx):
        return router.decode(router.encode(feats, idx), idx, max_new_tokens,
                             kv_int4=kv_int4, kv_int8=kv_int8)

    def routed():
        feats = _mel(cfg, params, audio)
        idx = router.route(feats)[0]
        return decode(feats, idx), idx

    toks_routed, idx0 = routed()

    def oracle():
        return decode(_mel(cfg, params, audio), idx0)

    # Routing must cost time, never tokens: the same indices, the same decode.
    agreement = _agreement(toks_routed, oracle())
    (t_routed, w_routed, _), (t_oracle, w_oracle, _), (t_lid, w_lid, _) = timed_rounds(
        [routed, oracle, lid_only], iters)
    _print_capture(f"routed batch={batch}", router.runner)
    return {"mode": "routed", "batch": batch, "kv": kv,
            "languages": len(langs), "lid_layer": lid_layer,
            "lora_rank": lora_rank,
            "routed_s_per_batch": round(t_routed, 4),
            "oracle_s_per_batch": round(t_oracle, 4),
            "rtfx_routed": round(batch * mel_ops.CHUNK_SECONDS / t_routed, 1),
            "rtfx_oracle": round(batch * mel_ops.CHUNK_SECONDS / t_oracle, 1),
            "routing_overhead_ms_per_utt":
                round((t_routed - t_oracle) * 1000 / batch, 3),
            "lid_ms_per_utt": round(t_lid * 1000 / batch, 3),
            "token_agreement_vs_oracle": agreement,
            "iter_s": {"routed": w_routed, "oracle": w_oracle, "lid": w_lid}}


def run_train(cfg, params, batch, accum, label_len, lora_rank, iters, device,
              remat=True, mesh=None):
    """Steady-state LoRA train-step throughput: `ASRTrainer.train_step`
    over `accum` microbatches of random mel and labels (forward, backward
    with K6 on the card, clipped AdamW); on `mesh`, each rank's rows of
    them."""
    from sar_tpu_torch.models import lora as lora_lib
    from sar_tpu_torch.training.trainer import ASRTrainer, TrainingArgs

    lcfg = lora_lib.LoraConfig(r=lora_rank, alpha=2 * lora_rank)
    bank = lora_lib.init_lora(torch.Generator().manual_seed(0), cfg, lcfg)
    targs = TrainingArgs(gradient_accumulation_steps=accum,
                         gradient_checkpointing=remat, device=str(device))
    trainer = ASRTrainer(cfg, params, bank, lcfg, targs, mesh=mesh)
    rng = np.random.default_rng(0)
    micro = [{"input_features": rng.standard_normal(
                  (batch, cfg.num_mel_bins, cfg.num_audio_frames)).astype(np.float32),
              "labels": rng.integers(0, cfg.vocab_size, (batch, label_len)).astype(np.int32),
              "texts": [""] * batch} for _ in range(accum)]
    dt, walls, _ = timed(lambda: trainer.train_step(micro), iters)
    return {"mode": "train", "batch": batch, "accum": accum,
            "label_len": label_len, "lora_rank": lora_rank, "remat": remat,
            "s_per_step": round(dt, 4),
            "examples_per_s": round(accum * batch / dt, 2),
            "iter_s": walls}


def run_config(cfg, params, batch, max_new_tokens, kv, iters, device,
               scores_int8=False, num_beams=1, agreement=True, layout="auto",
               capture=None, mesh=None):
    """One config row: mel -> encode -> cache -> greedy (or beam search),
    timed per batch through a DecodeRunner (the evaluator's programs; the
    cache its static one); with its agreement key where the JAX CLI has
    one. On `mesh` each rank runs its shard of the weights on its rows of
    the batch over a classic cache, as the JAX CLI's mesh rows."""
    from sar_tpu_torch.decode.graphs import (CudaGraphCapture, DecodeRunner,
                                             resolve_capture)
    from sar_tpu_torch.decode.greedy import greedy_decode_from_cache
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.ops import mel as mel_ops
    from sar_tpu_torch.parallel import distributed as pdist
    from sar_tpu_torch.parallel import sharding

    if scores_int8 and mesh is not None:
        # The evaluator's guard: no s8 decode under a mesh.
        logger.warning("--attn_scores int8 is unsupported under a mesh; "
                       "using bf16 scores")
        scores_int8 = False
    kv_int8, kv_int4 = kv == "int8", kv == "int4"
    flags = dict(cross_kv_int8=kv_int8, self_kv_int8=kv_int8,
                 cross_kv_int4=kv_int4, self_kv_int4=kv_int4)
    prompt = cfg.prompt_ids("hindi")
    total = min(len(prompt) + max_new_tokens, cfg.max_target_positions)
    audio = _audio(batch, device)
    tp = sharding.model_group(mesh)
    if mesh is not None:
        # Every rank's rows of the batch: the rates below are the batch's.
        audio = pdist.put_global_batch(audio, mesh)
        params = sharding.shard_params(params, mesh, cfg)
    flash = whisper.resolve_flash("auto", device)
    runner = DecodeRunner(params, cfg, tp=tp, capture=CudaGraphCapture
                          if resolve_capture(capture, device) and tp is None else None)

    @torch.no_grad()
    def encode():
        return whisper.encode(params, _mel(cfg, params, audio), cfg, flash=flash, tp=tp)

    # classic forces the [L,B,H,S,hd] layout, and so does a mesh; None
    # defers to the decoder's own choice (use_head_minor).
    beam_hm = False if layout == "classic" or mesh is not None else None
    hm = False
    if num_beams > 1:
        def run():
            enc = encode()
            cache = runner.prep(enc, total, self_batch=batch * num_beams,
                                head_minor=beam_hm, **flags)
            return runner.beam(cache, prompt, num_beams=num_beams,
                               scores_int8=scores_int8)
    else:
        hm = layout != "classic" and whisper.use_head_minor(**flags, mesh=mesh)

        def run():
            return runner.greedy(runner.prep(encode(), total, head_minor=hm, **flags),
                                 prompt, scores_int8=scores_int8)

    dt, walls, out = timed(run, iters)
    _print_capture(f"batch={batch} kv={kv} beams={num_beams}", runner)
    # The comparison decode below builds a cache of its own: the runner's
    # static cache and graphs go first, so that two caches never coexist.
    del run, runner
    row = {"batch": batch, "kv": kv,
           "attn_scores": "int8" if scores_int8 else "bf16",
           "layout": ("head_minor" if num_beams == 1 and hm else
                      "auto" if num_beams > 1 and beam_hm is None else
                      "classic"),
           "num_beams": num_beams,
           "seconds_per_batch": round(dt, 4),
           "rtfx": round(batch * mel_ops.CHUNK_SECONDS / dt, 1),
           "ms_per_token": round(dt / max_new_tokens * 1000, 3)}
    if num_beams == 1 and agreement:
        # Each approximate or kernel path against the exact int8 decode over
        # the classic layout (plain torch), as the JAX CLI compares them:
        # s8 scores, the head-minor slabs (the same quantization points,
        # another reduction order) and the int4 cache.
        classic = lambda: greedy_decode_from_cache(
            params, whisper.init_cache(params, encode(), cfg, max_len=total,
                                       cross_kv_int8=True, self_kv_int8=True,
                                       head_minor=False, tp=tp), cfg, prompt, tp=tp)
        if scores_int8:
            row["token_agreement_vs_bf16"] = _agreement(out, classic())
        elif kv_int8 and hm:
            row["token_agreement_vs_classic"] = _agreement(out, classic())
        if kv_int4:
            row["token_agreement_vs_int8"] = _agreement(out, classic())
    row["iter_s"] = walls
    return row


def _oom_row(device, **key) -> dict:
    logger.warning("out of device memory: %s", key)
    torch.cuda.empty_cache()
    return {**key, "error": "oom"}


def _report(args, rows, peaks, with_tokens=True) -> dict:
    report = {"model": args.model}
    if with_tokens:
        report["max_new_tokens"] = args.max_new_tokens
    report["results"] = rows
    if peaks:
        report["peak_mem_gb"] = peaks
    from sar_tpu_torch.parallel.distributed import is_main_process
    if args.output and is_main_process():
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(json.dumps(report, indent=2))
    return report


def main(argv=None) -> dict:
    args = parse_args(argv)
    from sar_tpu_torch.device import resolve_device
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.models.config import get_config
    from sar_tpu_torch.parallel.distributed import (is_main_process,
                                                    maybe_initialize_distributed)
    from sar_tpu_torch.parallel.sharding import mesh_device, mesh_from_flags

    maybe_initialize_distributed(device=args.device)
    mesh = mesh_from_flags(args.dp, args.tp, args.dcn_dp)
    if not is_main_process():
        logging.getLogger().setLevel(logging.WARNING)     # rank 0 logs
    device = resolve_device(args.device) if mesh is None else mesh_device(mesh)
    if mesh is not None:
        logger.info("benchmarking on mesh %s", mesh)
    capture = {"auto": None, "on": True, "off": False}[args.capture]
    logger.warning("no pretrained weights are read: random init (seed 0); "
                   "throughput numbers are unaffected")
    cfg = get_config(args.model)
    g = torch.Generator(device=device).manual_seed(0)
    params = whisper.cast_params(whisper.init_params(cfg, g, device), torch.bfloat16)
    rows: list[dict] = []
    peaks: list[float] = []     # torch.cuda.max_memory_allocated per row (GB)

    def measured(fn, **key):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        try:
            r = fn()
        except torch.cuda.OutOfMemoryError:
            r = _oom_row(device, **key)
        rows.append(r)
        if device.type == "cuda":
            peaks.append(round(torch.cuda.max_memory_allocated(device) / 1e9, 3))
        return r

    if args.train:
        for b in args.batch_sizes:
            r = measured(lambda: run_train(cfg, params, b, args.train_accum,
                                           args.train_label_len, args.train_lora_rank,
                                           args.iters, device,
                                           remat=args.train_remat == "on",
                                           mesh=mesh),
                         mode="train", batch=b, accum=args.train_accum)
            if "error" not in r:
                print(f"train batch={b} x accum={r['accum']}: {r['s_per_step']} s/step "
                      f"= {r['examples_per_s']} ex/s (labels {r['label_len']}, "
                      f"r{r['lora_rank']}) walls {r['iter_s']}")
        return _report(args, rows, peaks, with_tokens=False)
    if args.routed:
        if mesh is not None:
            logger.warning("--routed benchmarks the single-chip routed program; "
                           "ignoring the mesh flags")
        for b in args.batch_sizes:
            r = measured(lambda: run_routed(cfg, params, b, args.max_new_tokens,
                                            args.iters, args.kv_cache[0],
                                            args.routed_languages,
                                            args.routed_lid_layer,
                                            args.routed_lora_rank, device,
                                            capture=capture),
                         mode="routed", batch=b)
            if "error" not in r:
                print(f"routed batch={b} ({r['languages']} langs, LID layer "
                      f"{r['lid_layer']}): {r['rtfx_routed']} RTFx vs oracle "
                      f"{r['rtfx_oracle']} — overhead {r['routing_overhead_ms_per_utt']} "
                      f"ms/utt (LID alone {r['lid_ms_per_utt']} ms/utt), token "
                      f"agreement {r['token_agreement_vs_oracle']}")
        return _report(args, rows, peaks)
    if args.serving:
        if mesh is not None:
            logger.warning("--serving benchmarks the single-chip serving program; "
                           "ignoring the mesh flags")
        for b in args.batch_sizes:
            r = measured(lambda: run_serving(cfg, params, b, args.max_new_tokens,
                                             args.serving_requests,
                                             args.serving_wait_ms, device,
                                             capture=capture),
                         mode="serving", batch=b)
            if "error" not in r:
                print(f"serving batch={b}: {r['requests_per_s']} req/s "
                      f"({r['audio_sec_per_s']} audio-sec/s), p50 "
                      f"{r['latency_ms_p50']} ms, p95 {r['latency_ms_p95']} ms "
                      f"({r['batches']} batches)")
        return _report(args, rows, peaks)
    if args.streaming:
        if mesh is not None:
            logger.warning("--streaming benchmarks the single-chip streaming program; "
                           "ignoring the mesh flags")
        for kv in args.kv_cache:
            r = measured(lambda: run_streaming(cfg, params, args.streaming_chunk_seconds,
                                               args.iters, kv == "int8",
                                               args.max_new_tokens, device,
                                               capture=capture),
                         mode="streaming", kv=kv)
            if "error" not in r:
                print(f"streaming kv={r['kv']}: {r['ms_per_update_mean']} ms/update "
                      f"(p90 {r['ms_per_update_p90']}), rtf {r['streaming_rtf']}x "
                      f"({r['updates_per_window']} updates/window)")
        return _report(args, rows, peaks)
    print(f"{'batch':>6} {'kv':>5} {'scores':>7} {'beams':>6} {'s/batch':>9} "
          f"{'RTFx':>8} {'ms/tok':>8} {'agree':>7}")
    for kv in args.kv_cache:
        if args.attn_scores == "int8" and kv != "int8":
            logger.warning("--attn_scores int8 requires int8 KV; skipping "
                           "kv=%s rows", kv)
            continue
        for nb in args.num_beams:
            for b in args.batch_sizes:
                r = measured(lambda: run_config(cfg, params, b, args.max_new_tokens,
                                                kv, args.iters, device,
                                                scores_int8=args.attn_scores == "int8",
                                                num_beams=nb,
                                                agreement=not args.no_agreement,
                                                layout=args.kv_layout,
                                                capture=capture, mesh=mesh),
                             batch=b, kv=kv, attn_scores=args.attn_scores,
                             num_beams=nb)
                if "error" in r:
                    print(f"{b:>6} {kv:>5} {args.attn_scores:>7} {nb:>6} oom")
                    continue
                agree = r.get("token_agreement_vs_bf16", r.get(
                    "token_agreement_vs_int8", r.get("token_agreement_vs_classic", "-")))
                print(f"{r['batch']:>6} {r['kv']:>5} {r['attn_scores']:>7} "
                      f"{r['num_beams']:>6} {r['seconds_per_batch']:>9} "
                      f"{r['rtfx']:>8} {r['ms_per_token']:>8} {agree:>7} "
                      f"(layout {r['layout']}, walls {r['iter_s']}"
                      f"{f', peak {peaks[-1]} GB' if peaks else ''})")
    return _report(args, rows, peaks)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
