"""Evaluate a model (optionally with a LoRA adapter): transcribe a split,
print corpus WER/CER, and write metrics.json (+ predictions) when asked.

    python -m sar_tpu_torch.scripts.evaluate_model --checkpoint none \\
        --model whisper-test --language english --data_sources synthetic \\
        --num_beams 2 --max_new_tokens 12 --device cpu --output_dir out/

The port of scripts/evaluate_model.py. `--checkpoint` takes a sar_tpu /
sar_tpu_torch adapter directory or a PEFT one (or its parent holding an
`adapter/` subdirectory), or `none` for the base model. Runs on the CUDA
card unless `--device` says otherwise. Real Whisper weights and corpora
wait for files in the repository, so `--model` whisper-test with the
`synthetic` source is what runs today. `--attn_scores int8` (s8 scores,
kernel K7) and `--kv_cache int4` (the nibble-packed cache) are the opt-in
quantized decode, refused together as the evaluator refuses them. Flags of
the JAX script that the port has not got (meshes, fallback, a bf16 cache,
...) fail with a message.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import torch

logger = logging.getLogger("evaluate_model")

# Flags of the JAX script the port does not have yet.
NOT_PORTED = ("--platform", "--dp", "--tp", "--dcn_dp", "--best_of",
              "--fallback", "--cache_dir")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate an ASR model (PyTorch port)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="Adapter checkpoint dir (or 'none' for the base model)")
    p.add_argument("--model", type=str, default="whisper-small",
                   choices=["whisper-tiny", "whisper-base", "whisper-small",
                            "whisper-medium", "whisper-large", "whisper-test"])
    p.add_argument("--language", type=str, required=True)
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--data_sources", type=str, nargs="+",
                   default=["common_voice"])
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--task", type=str, default="transcribe",
                   choices=["transcribe", "translate"])
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--mixed_precision", type=str, default="bf16",
                   choices=["no", "fp16", "bf16"],
                   help="fp16 runs in bf16, as in the JAX script")
    p.add_argument("--kv_cache", type=str, default="int8",
                   choices=["int8", "bf16", "int4"],
                   help="int8 (default) or int4 (nibble-packed, opt-in); the "
                        "port has no bf16 cache")
    p.add_argument("--attn_scores", type=str, default="bf16",
                   choices=["bf16", "int8"],
                   help="int8: s8 query and probabilities in the decode's "
                        "attention (kernel K7 on the card; approximate, opt-in, "
                        "needs --kv_cache int8)")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--save_predictions", action="store_true")
    p.add_argument("--per_sample", action="store_true",
                   help="Also write per-sample WER/CER rows (per_sample.json)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    for flag in NOT_PORTED:
        p.add_argument(flag, nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    given = [f for f in NOT_PORTED if getattr(args, f[2:]) is not None]
    if given:
        p.error(f"{', '.join(given)}: not ported to sar_tpu_torch yet "
                f"(use scripts/evaluate_model.py, the JAX version)")
    if args.kv_cache == "bf16":
        p.error("--kv_cache bf16: sar_tpu_torch has the int8 and int4 "
                "caches only")
    from sar_tpu_torch.evaluation.evaluator import quantized_decode_options
    try:
        quantized_decode_options(args.kv_cache == "int8", args.kv_cache == "int4",
                                 args.attn_scores == "int8")
    except ValueError as e:
        p.error(f"--attn_scores {args.attn_scores} --kv_cache {args.kv_cache}: "
                f"{e} (sar_tpu_torch ASREvaluator)")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    from sar_tpu_torch.data import (DataLoader, create_collator,
                                    create_dataset, get_tokenizer)
    from sar_tpu_torch.device import resolve_device
    from sar_tpu_torch.evaluation import ASREvaluator
    from sar_tpu_torch.models import lora as lora_lib
    from sar_tpu_torch.models.base import load_base_model
    from sar_tpu_torch.training.metrics import compute_metrics_per_sample

    device = resolve_device(args.device)
    dtype = torch.float32 if args.mixed_precision == "no" else torch.bfloat16
    cfg, params = load_base_model(args.model, dtype=dtype, device=device)
    tokenizer = get_tokenizer(args.model, language=args.language, task=args.task)

    lora, lora_scale = None, 1.0
    if args.checkpoint not in (None, "none"):
        ckpt = Path(args.checkpoint)
        adapter_dir = ckpt / "adapter" if (ckpt / "adapter").exists() else ckpt
        if not (adapter_dir / "adapter_config.json").exists():
            raise SystemExit(
                f"error: no adapter found at {ckpt} (expected "
                f"adapter_config.json in it or in an adapter/ subdir); "
                f"use --checkpoint none for the base model")
        lora, lcfg, meta = lora_lib.load_any_adapter(adapter_dir, cfg, device)
        lora_scale = lcfg.scale
        logger.info("loaded adapter %s (r=%d, alpha=%d, meta=%s)",
                    adapter_dir, lcfg.r, lcfg.alpha, meta)

    ds = create_dataset(language=args.language, sources=args.data_sources,
                        split=args.split, max_samples=args.max_samples,
                        seed=args.seed, model_config=cfg)
    loader = DataLoader(ds, args.batch_size,
                        create_collator(cfg.sot_token_id,
                                        num_mels=cfg.num_mel_bins,
                                        num_frames=cfg.num_audio_frames,
                                        device=device),
                        shuffle=False, drop_last=False)
    logger.info("evaluating %d samples (%s/%s) on %s", len(ds), args.language,
                args.split, device)
    evaluator = ASREvaluator(cfg, params, tokenizer, language=args.language,
                             max_new_tokens=args.max_new_tokens,
                             num_beams=args.num_beams, lora=lora,
                             lora_scale=lora_scale, task=args.task,
                             kv_int8=args.kv_cache == "int8",
                             kv_int4=args.kv_cache == "int4",
                             scores_int8=args.attn_scores == "int8",
                             device=device)
    need_preds = args.save_predictions or args.per_sample
    results = evaluator.evaluate(loader, return_predictions=need_preds)

    print(f"WER: {results['wer'] * 100:.2f}%")
    print(f"CER: {results['cer'] * 100:.2f}%")
    print(f"Samples: {results['num_samples']}")

    if args.output_dir:
        to_save = results if args.save_predictions else {
            k: v for k, v in results.items()
            if k not in ("predictions", "references")}
        evaluator.save_results(to_save, args.output_dir)
        if args.per_sample:
            per = compute_metrics_per_sample(results["predictions"],
                                             results["references"])
            for row, p, r in zip(per, results["predictions"],
                                 results["references"]):
                row["prediction"], row["reference"] = p, r
            (Path(args.output_dir) / "per_sample.json").write_text(
                json.dumps(per, indent=2, ensure_ascii=False))
        logger.info("wrote results to %s", args.output_dir)
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
