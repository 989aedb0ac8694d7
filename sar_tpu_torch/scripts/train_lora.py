"""Train a per-language LoRA adapter on Whisper (the paper's Phase 1).

    python -m sar_tpu_torch.scripts.train_lora --model whisper-test \\
        --language english --data_sources synthetic --max_steps 12 \\
        --device cpu --output_dir out/lora_english

The port of scripts/train_lora.py, with its flags and defaults plus
`--device` (default: the CUDA card). It writes output_dir/config.yaml, the
best-WER checkpoint under best/, periodic step_N/ checkpoints, the final
adapter under final/ and history.json. `--flash_attention auto` runs the
three attentions of a step through kernel K6 on the card. Real Whisper
weights and corpora wait for files in the repository, so `--model
whisper-test` with `--data_sources synthetic` is what runs today; device
meshes (`--dp/--tp/--dcn_dp`), `--platform`, `--num_workers`,
`--cache_dir` and the other sources are refused with a message.
"""

from __future__ import annotations

import argparse
import json
import logging
import random
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("train_lora")

LANGUAGES = ["hindi", "italian", "punjabi", "telugu", "english", "german",
             "french", "spanish"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train LoRA adapters for ASR "
                                            "(PyTorch port)")
    p.add_argument("--model", type=str, default="whisper-small",
                   choices=["whisper-tiny", "whisper-base", "whisper-small",
                            "whisper-medium", "whisper-large", "whisper-test"])
    p.add_argument("--language", type=str, required=True, choices=LANGUAGES)
    # LoRA
    p.add_argument("--lora_rank", type=int, default=16)
    p.add_argument("--lora_alpha", type=int, default=32)
    p.add_argument("--lora_dropout", type=float, default=0.1)
    p.add_argument("--target_modules", type=str, nargs="+",
                   default=["q_proj", "v_proj"])
    # Data
    p.add_argument("--data_sources", type=str, nargs="+",
                   default=["common_voice"])
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--max_duration", type=float, default=30.0)
    p.add_argument("--min_duration", type=float, default=1.0)
    p.add_argument("--max_label_length", type=int, default=448,
                   help="Label pad length (the decoder's T)")
    # Training
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--gradient_accumulation_steps", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=5e-4)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--warmup_steps", type=int, default=500)
    p.add_argument("--max_steps", type=int, default=5000)
    p.add_argument("--eval_steps", type=int, default=1000)
    p.add_argument("--scheduler_type", type=str, default="linear")
    p.add_argument("--mixed_precision", type=str, default="bf16",
                   choices=["no", "fp16", "bf16"])
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--dp", type=int, default=1, help="not ported: must be 1")
    p.add_argument("--tp", type=int, default=1, help="not ported: must be 1")
    p.add_argument("--dcn_dp", type=int, default=1, help="not ported: must be 1")
    p.add_argument("--num_workers", type=int, default=0,
                   help="not ported: must be 0 (the loader collates on one "
                        "background thread)")
    p.add_argument("--platform", type=str, default="auto",
                   choices=["auto", "cpu", "tpu"],
                   help="not ported: use --device")
    p.add_argument("--flash_attention", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="Blockwise attention K6 (auto = on on the card; it "
                        "takes bf16 only, so --mixed_precision no on the "
                        "card needs off)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    # Output
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--save_total_limit", type=int, default=3)
    # W&B
    p.add_argument("--wandb_project", type=str, default="whisper-lora-adapters")
    p.add_argument("--wandb_run_name", type=str, default=None)
    p.add_argument("--no_wandb", action="store_true")
    # Other
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--cache_dir", type=str, default=None,
                   help="not ported (no weight downloads)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--early_stopping_patience", type=int, default=5)
    p.add_argument("--resume_from", type=str, default=None)
    args = p.parse_args(argv)
    meshes = [f"--{k} {getattr(args, k)}" for k in ("dp", "tp", "dcn_dp")
              if getattr(args, k) != 1]
    if meshes:
        p.error(f"{', '.join(meshes)}: device meshes are not ported to "
                f"sar_tpu_torch yet (train on one card; scripts/train_lora.py "
                f"is the JAX version)")
    if args.num_workers:
        p.error(f"--num_workers {args.num_workers}: collation worker pools are "
                f"not ported to sar_tpu_torch (the loader prefetches on one "
                f"thread)")
    if args.cache_dir is not None:
        p.error("--cache_dir: not ported to sar_tpu_torch (real Whisper weights "
                "wait for files in the repository)")
    if args.platform != "auto":
        p.error(f"--platform {args.platform}: not ported to sar_tpu_torch "
                f"(use --device)")
    if args.data_sources != ["synthetic"]:
        p.error(f"--data_sources {' '.join(args.data_sources)}: sar_tpu_torch "
                f"has the 'synthetic' source only; the real corpora wait for "
                f"data in the repository")
    return args


def set_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def main(argv=None) -> dict:
    args = parse_args(argv)
    set_seed(args.seed)
    from sar_tpu_torch.data import (DataLoader, create_collator,
                                    create_dataset, get_tokenizer)
    from sar_tpu_torch.device import resolve_device
    from sar_tpu_torch.models import lora as lora_lib
    from sar_tpu_torch.models.base import load_base_model
    from sar_tpu_torch.training import (ASRTrainer, CheckpointCallback,
                                        EarlyStoppingCallback, TrainingArgs,
                                        WandbCallback)

    device = resolve_device(args.device)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.yaml").write_text(
        "\n".join(f"{k}: {json.dumps(v)}" for k, v in sorted(vars(args).items()))
        + "\n")

    dtype = torch.float32 if args.mixed_precision == "no" else torch.bfloat16
    cfg, params = load_base_model(args.model, dtype=dtype, device=device)
    tokenizer = get_tokenizer(args.model, language=args.language)

    lcfg = lora_lib.LoraConfig(r=args.lora_rank, alpha=args.lora_alpha,
                               dropout=args.lora_dropout,
                               target_modules=tuple(args.target_modules))
    bank = lora_lib.init_lora(torch.Generator().manual_seed(args.seed), cfg, lcfg)
    logger.info("trainable: %s", lora_lib.trainable_summary(bank, params))

    common = dict(language=args.language, sources=args.data_sources,
                  seed=args.seed, model_config=cfg)
    train_ds = create_dataset(split="train", max_samples=args.max_samples,
                              **common)
    val_cap = args.max_samples // 10 if args.max_samples else None
    val_ds = create_dataset(split="validation", max_samples=val_cap, **common)
    logger.info("train=%d validation=%d samples", len(train_ds), len(val_ds))

    coll = create_collator(cfg.sot_token_id, pad_to_length=args.max_label_length,
                           num_mels=cfg.num_mel_bins,
                           num_frames=cfg.num_audio_frames, device=device)
    train_loader = DataLoader(train_ds, args.batch_size, coll, seed=args.seed)
    eval_loader = DataLoader(val_ds, args.batch_size, coll, shuffle=False,
                             drop_last=False)

    callbacks = [
        CheckpointCallback(out, save_steps=args.save_steps,
                           save_total_limit=args.save_total_limit),
        EarlyStoppingCallback(patience=args.early_stopping_patience),
    ]
    if not args.no_wandb:
        callbacks.insert(0, WandbCallback(project=args.wandb_project,
                                          name=args.wandb_run_name,
                                          config=vars(args)))

    targs = TrainingArgs(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, max_steps=args.max_steps,
        eval_steps=args.eval_steps, scheduler=args.scheduler_type,
        mixed_precision=args.mixed_precision,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        max_new_tokens=args.max_new_tokens,
        flash_attention=args.flash_attention, seed=args.seed,
        device=str(device))
    trainer = ASRTrainer(cfg, params, bank, lcfg, targs, tokenizer=tokenizer,
                         language=args.language, callbacks=callbacks)
    if args.resume_from:
        trainer.load_checkpoint(args.resume_from)
        logger.info("resumed from %s at step %d", args.resume_from,
                    trainer.global_step)

    history = trainer.train(train_loader, eval_loader)

    lora_lib.save_adapter(out / "final", trainer.lora, trainer.lora_cfg,
                          metadata={"language": args.language,
                                    "model": args.model,
                                    "global_step": trainer.global_step})
    (out / "history.json").write_text(json.dumps(
        {"loss": history["loss"][-50:], "eval": history["eval"]}, indent=2))
    logger.info("done; final adapter at %s", out / "final")
    return history


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
