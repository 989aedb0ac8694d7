"""Offline evaluation cells: `ASREvaluator.from_audio` over host float32
batches, back to back, as an evaluation or batch-transcription job feeds it.

Each clip decodes in the workload's `language`, or, for a mix with
`languages`, in its own (per-row prompts, as a multilingual evaluation
passes them). The window runs whole batches until `--seconds` have passed
and ends with
the last batch's result; `rtfx` is the audio seconds of every clip it
transcribed, each at its own duration, over the window's wall time. Set-up
makes the weights and a pool of batches from the seed, builds the
evaluator and runs the cell's own batch shape twice (the first call
captures the decode loop's CUDA graphs, the second replays them). A traced
run wraps the evaluator's layers in spans over the window, then profiles
one more batch of the same shape.

`correct`: a sample of the transcribed clips, drawn from the seed with the
longest in it, is run through the plain reference (its own mel, encoder
and teacher-forced decoder in float32) on the clip's audio and its served
tokens, and the widest gap by which a served token's reference logit lies
below the reference's best must stay under the workload's limit.
"""

from __future__ import annotations

import time

import torch

from benchmarks import harness, weights
from benchmarks.counts import whisper as counts
from benchmarks.reference import compare, mel as ref_mel, whisper as ref
from benchmarks.spans import Spans
from benchmarks.traffic import audio as audio_traffic


def program_config(c: dict):
    from sar_tpu_torch.models.config import get_config
    cfg = get_config(c["program_config"])
    weights.check_config(cfg, c)
    return cfg


def _counters() -> dict:
    from sar_tpu_torch.decode import segments
    return {"steps": sum(segments.STEPS.values()), "host_syncs": segments.HOST_SYNCS}


def batch_work(c: dict, w: dict, prompt_len: int, batches: int) -> dict:
    """What `batches` batches of the cell need: model FLOPs and the kernels'
    calls (every row decodes to max_new_tokens, the longest row's length)."""
    B, new = w["traffic"]["batch"], w["max_new_tokens"]
    steps = prompt_len + new - 1
    flops = (counts.encoder_flops(c, B) + counts.cross_cache_flops(c, B)
             + counts.decode_flops(c, B, prompt_len, new))
    return {"batches": batches, "batch": B, "steps": batches * steps,
            "flops": batches * flops, "k1_calls": batches * c["encoder_layers"],
            "k2_calls": batches, "k3_calls": batches * steps * c["decoder_layers"]}


def alter_token(runner, pos: int, vocab: int) -> None:
    """The fault "token": the runner's greedy loop returns row 0 with the
    token at `pos` changed, as if the program produced a wrong one."""
    greedy = runner.greedy

    def wrong(*args, **kwargs):
        out = greedy(*args, **kwargs).clone()
        out[0, pos] = (out[0, pos] + 1) % vocab
        return out
    runner.greedy = wrong


def row_prompts(cfg, b, device):
    """Each clip's decoder prompt [B, P] for a mix of languages; None (the
    evaluator's own language) for a one-language mix."""
    if not b.languages:
        return None
    return torch.tensor([cfg.prompt_ids(lang) for lang in b.languages], device=device)


def run(ctx):
    from sar_tpu_torch.evaluation.evaluator import ASREvaluator
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.ops import mel as mel_ops

    w, c, dev = ctx.cell.workload, ctx.cell.config, ctx.device
    marks = [("start", time.perf_counter())]
    cfg = program_config(c)
    params = whisper.cast_params(weights.make(c, ctx.seed, dev), torch.bfloat16)
    marks.append(("weights", time.perf_counter()))
    ev = ASREvaluator(cfg, params, None, language=w["language"],
                      max_new_tokens=w["max_new_tokens"], kv_int8=w["kv_int8"],
                      flash=w["flash"], kernels=w.get("kernels", True),
                      capture=w.get("capture"), device=dev)
    prompt_len = len(cfg.prompt_ids(w["language"]))
    if ctx.fault == "token":
        alter_token(ev.runner, prompt_len + 1, c["vocab_size"])
    elif ctx.fault:
        raise ValueError(f"eval cells plant only the fault 'token', not {ctx.fault!r}")
    pool = [audio_traffic.batch(w["traffic"], ctx.seed, i, dev)
            for i in range(w["traffic"]["pool"])]
    prompts = [row_prompts(cfg, b, dev) for b in pool]
    marks.append(("evaluator and traffic", time.perf_counter()))
    for i in range(w.get("warmup_batches", 2)):
        ev.from_audio(pool[i % len(pool)].clips, prompts[i % len(pool)])
        marks.append((f"warm-up batch {i}", time.perf_counter()))

    spans = Spans(dev) if ctx.trace else None
    if spans:
        start = {}
        spans.wrap(mel_ops, "log_mel_spectrogram", "frontend", start=lambda: start["batch"])
        spans.wrap(ev, "encode", "encode")
        spans.wrap(ev.runner, "prep", "prep")
        spans.wrap(ev.runner, "greedy", "decode")
    before = _counters()
    served: list[tuple[int, int, list]] = []      # (pool index, row, ids)
    audio_s = 0.0
    t0 = ctx.start_window()
    walls = [t0]
    n = 0
    while True:
        b, p = pool[n % len(pool)], prompts[n % len(pool)]
        if spans:
            start["batch"] = spans.mark()
            with torch.profiler.record_function("bench.batch"):
                ids = ev.from_audio(b.clips, p)
        else:
            ids = ev.from_audio(b.clips, p)
        served.extend((n % len(pool), r, row) for r, row in enumerate(ids))
        audio_s += float(b.durations.sum())
        n += 1
        walls.append(time.perf_counter())
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    after = _counters()

    trace = None
    if spans:
        span_ms = spans.result()
        b, p = pool[n % len(pool)], prompts[n % len(pool)]

        def one_batch():
            start["batch"] = spans.mark()
            with torch.profiler.record_function("bench.batch"):
                ev.from_audio(b.clips, p)
        kernels, host, wall = harness.profiled(one_batch, dev)
        spans.restore()
        trace = harness.Trace(kernels=kernels, host=host, profiled_s=wall,
                              spans=span_ms,
                              counters={k: after[k] - before[k] for k in after},
                              work=batch_work(c, w, prompt_len, n),
                              profiled_work=batch_work(c, w, prompt_len, 1),
                              config=c, window_s=window_s)

    rows = compare.sample(served, w["check"]["rows"], audio_traffic.rng(ctx.seed, 13),
                          lambda item: len(item[2]))
    state = {"ev": ev, "params": params, "pool": pool}

    def release():
        state.clear()

    return harness.Outcome(
        attempted=len(served), failed=0, metrics={"rtfx": audio_s / window_s},
        release=release, trace=trace,
        check=lambda control=False: _check(ctx, c, cfg, w, prompt_len, rows, control),
        notes={"batches": n, "window_s": window_s,
               "batch_s": [round(y - x, 4) for x, y in zip(walls, walls[1:])],
               "setup": [(k, round(t - a, 3)) for (_, a), (k, t) in zip(marks, marks[1:])]})


MEL_CHUNK = 32        # clips per batch of the reference's log-mel


def served_tokens(ids: list, max_new: int, eos: int) -> list:
    """The tokens a row served: its ids, and the EOS that ended it early."""
    return list(ids) + ([eos] if len(ids) < max_new else [])


def _check(ctx, c, cfg, w, prompt_len, rows, control: bool = False) -> list:
    """The widest gap of the sampled rows' served tokens under the
    reference; with `control`, also the gap of the tokens the float8
    control puts first at the same positions (returned as a second check)."""
    dev = ctx.device
    W = weights.make(c, ctx.seed, dev)
    worst, worst_ctl = 0.0, 0.0
    batches = {}
    with torch.no_grad(), ref.exact_float32():
        for lo in range(0, len(rows), MEL_CHUNK):
            chunk = rows[lo:lo + MEL_CHUNK]
            clips, langs = [], []
            for pool_i, r, _ in chunk:
                if pool_i not in batches:
                    batches[pool_i] = audio_traffic.batch(w["traffic"], ctx.seed, pool_i, dev)
                b = batches[pool_i]
                clips.append(b.clip(r))
                langs.append(b.languages[r] if b.languages else w["language"])
            mels = ref_mel.log_mel(clips, c["num_mel_bins"], dev)
            for (_, _, ids), mel, lang in zip(chunk, mels, langs):
                toks = served_tokens(ids, w["max_new_tokens"], cfg.eos_token_id)
                seq = torch.tensor(cfg.prompt_ids(lang) + toks, device=dev)[:-1]
                logits = ref.decoder_logits(W, c, ref.encode(W, c, mel), seq)
                worst = max(worst, float(compare.served_gaps(logits, prompt_len, toks).max()))
                if control:
                    ctl = ref.decoder_logits(W, c, ref.encode(W, c, mel, prec=ref.FP8), seq,
                                             prec=ref.FP8)
                    worst_ctl = max(worst_ctl, float(compare.control_gaps(
                        logits, ctl, prompt_len, len(toks)).max()))
    lim = w["check"]["max_logit_gap"]
    out = [compare.check("max_logit_gap", worst, lim)]
    if control:
        out.append(compare.check("control_fp8_max_logit_gap", worst_ctl, lim))
    return out
