"""Offline promotion gate for the opt-in quantized decode paths (s8 scores,
int4 KV), the port of scripts/s8_gate.py.

    python -m sar_tpu_torch.scripts.s8_gate --quant s8 \\
        --output out/s8_gate.json [--models whisper-small] [--batches 8 64] \\
        [--max_new_tokens 256] [--no_probe] [--device cpu]

`--quant s8` gates `scores_int8` (the query and the attention
probabilities quantized to s8, kernel K7 on the card) against exact scores
(K3), both over the int8 head-minor cache; `--quant int4` gates the
nibble-packed int4 cache against the int8 one, both with exact scores.
For each model x batch (random bf16 weights from seed 0, random 30 s audio
from seed = batch) it runs BOTH greedy drivers:

- two-phase: `ASREvaluator.prep` (encoder + cache) then `ASREvaluator.dec`
  (the loop over the prepared cache), candidate and reference each;
- direct: `greedy_decode` from the encoder output;

and records the share of rows whose tokens are all equal
(`agreement_twophase`, `agreement_direct`), the wall seconds of each
two-phase decode (`decode_s_<candidate>`, `decode_s_<reference>`; the
first one includes the kernels' build), and, unless `--no_probe`, the
max |logit delta| over the first 4 forced prompt steps. `"pass"` is every
agreement 1.0. Random weights are the worst case for ties; real speech
distributions are peakier.

The report is written to `--output` only. The gate runs on the CUDA card
unless `--device` says otherwise; `"kernel"` says whether K7 was launched.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe_logit_delta(ev_a, ev_b, feats, n_steps: int = 4) -> float:
    """Max |logits_candidate - logits_reference| over the first `n_steps`
    forced prompt steps, each from its own freshly built cache."""
    from sar_tpu_torch.models import whisper
    cache_a, cache_b = ev_a.prep(feats), ev_b.prep(feats)
    prompt = ev_a._prompt
    worst = 0.0
    with torch.inference_mode():
        for pos in range(min(n_steps, prompt.shape[0])):
            tok = prompt[pos].expand(feats.shape[0])
            la, cache_a = whisper.decode_step(ev_a.params, tok, pos, cache_a, ev_a.cfg,
                                              scores_int8=ev_a.scores_int8)
            lb, cache_b = whisper.decode_step(ev_b.params, tok, pos, cache_b, ev_b.cfg)
            worst = max(worst, float((la - lb).abs().max()))
    return worst


def run_cell(model: str, batch: int, max_new_tokens: int, probe: bool,
             quant: str, device: torch.device) -> dict:
    """One gate cell (see the module docstring)."""
    from sar_tpu_torch.decode import greedy_decode
    from sar_tpu_torch.evaluation import ASREvaluator
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.models.config import get_config
    from sar_tpu_torch.ops import mel as mel_ops

    cfg = get_config(model)
    g = torch.Generator(device=device).manual_seed(0)
    params = whisper.cast_params(whisper.init_params(cfg, g, device), torch.bfloat16)
    rng = np.random.default_rng(batch)
    audio = torch.from_numpy(
        (rng.standard_normal((batch, mel_ops.N_SAMPLES)) * 0.1).astype(np.float32)).to(device)
    feats = mel_ops.log_mel_spectrogram(audio, cfg.num_mel_bins,
                                        dtype=torch.bfloat16)[:, :, :cfg.num_audio_frames]
    int4 = quant == "int4"
    cand = dict(kv_int4=True) if int4 else dict(scores_int8=True)
    ev_a = ASREvaluator(cfg, params, max_new_tokens=max_new_tokens, device=device, **cand)
    ev_b = ASREvaluator(cfg, params, max_new_tokens=max_new_tokens, device=device)

    def two_phase(ev):
        cache = ev.prep(feats)
        _sync(device)
        t0 = time.perf_counter()
        tokens = ev.dec(cache)
        _sync(device)
        return tokens, time.perf_counter() - t0

    tok_a, t_a = two_phase(ev_a)
    tok_b, t_b = two_phase(ev_b)
    enc = ev_b.encode(feats)
    with torch.inference_mode():
        d_a = greedy_decode(params, enc, cfg, ev_a._prompt, max_new_tokens=max_new_tokens,
                            cross_kv_int8=not int4, self_kv_int8=not int4,
                            cross_kv_int4=int4, self_kv_int4=int4,
                            scores_int8=not int4)
        d_b = greedy_decode(params, enc, cfg, ev_b._prompt, max_new_tokens=max_new_tokens,
                            cross_kv_int8=True, self_kv_int8=True)
    a_key, b_key = ("int4", "int8") if int4 else ("s8", "bf16")
    cell = {
        "model": model, "batch": batch,
        "agreement_twophase": float((tok_a == tok_b).all(dim=1).float().mean()),
        "agreement_direct": float((d_a == d_b).all(dim=1).float().mean()),
        f"decode_s_{a_key}": round(t_a, 3),
        f"decode_s_{b_key}": round(t_b, 3),
    }
    if probe:
        cell["max_logit_delta"] = round(probe_logit_delta(ev_a, ev_b, feats), 5)
    return cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--models", nargs="+",
                   default=["whisper-small", "whisper-medium", "whisper-large"])
    p.add_argument("--batches", nargs="+", type=int, default=[8, 64])
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--no_probe", action="store_true",
                   help="Skip the per-step logit-delta probe")
    p.add_argument("--quant", choices=["s8", "int4"], default="s8",
                   help="s8 = s8 attention scores (K7); int4 = the nibble-packed "
                        "int4 KV cache (vs the default int8 one)")
    p.add_argument("--output", required=True,
                   help="Report path (JSON); nothing else is written")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    from sar_tpu_torch.device import resolve_device
    from sar_tpu_torch.ops import decode_cross
    device = resolve_device(args.device)
    launched = decode_cross.S8_LAUNCHES
    cells = []
    for model in args.models:
        for batch in args.batches:
            print(f"gate cell {model} B={batch} ...", flush=True)
            cell = run_cell(model, batch, args.max_new_tokens, not args.no_probe,
                            args.quant, device)
            print(json.dumps(cell), flush=True)
            cells.append(cell)
    ok = all(c["agreement_twophase"] == 1.0 and c["agreement_direct"] == 1.0
             for c in cells)
    report = {
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else device.type),
        "quant": args.quant,
        "kernel": decode_cross.S8_LAUNCHES > launched,
        "max_new_tokens": args.max_new_tokens,
        "pass": ok,
        "cells": cells,
    }
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps({"pass": ok, "cells": len(cells), "device": report["device"]}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
