"""Train the Phase-2 LID classifier on frozen Whisper encoder features.

    python -m sar_tpu_torch.scripts.train_router --base_model whisper-test \\
        --languages english german --data_sources synthetic \\
        --hidden_dims 32 --max_steps 120 --device cpu --output_dir out/router

The port of scripts/train_router.py, with its flags and defaults plus
`--device` (default: the CUDA card). It writes output_dir/config.yaml,
the classifier (and its train_state.pt) under output_dir/classifier/ and
history.json; `models.router.build_router_from_checkpoints` routes with
that classifier. `--encoder_layer` keeps the JAX script's default of -1
(the final post-LN output) for parity, although LID_BENCH.json's sweep
picked layer 3 with mean pooling, which costs 4 encoder layers instead of
all of them: pass `--encoder_layer 3` for that.

Where the JAX script is at fault, this one is not: `--cache_features`
precomputes the training features from a loader that drops no sample (the
JAX script reads its drop_last train loader, so up to batch_size - 1
samples never train), and `--cache_features` with
`--gradient_accumulation_steps` > 1 is refused (the JAX script runs it at
1). `--dp/--tp/--dcn_dp` train on a device mesh, one process per device
(`torchrun --nproc_per_node N -m sar_tpu_torch.scripts.train_router ...`):
the frozen encoder runs data and tensor parallel, the head is replicated,
rank 0 alone writes the outputs; `--cache_features` is a single-process
path and refuses a mesh, as the JAX trainer does. Real Whisper weights and
corpora wait for files in the repository, so `--base_model whisper-test`
with `--data_sources synthetic` is what runs today; `--platform`,
`--cache_dir` and the other sources are refused with a message.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import torch

logger = logging.getLogger("train_router")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train LID classifier (PyTorch port)")
    p.add_argument("--base_model", type=str, default="whisper-small",
                   choices=["whisper-tiny", "whisper-base", "whisper-small",
                            "whisper-medium", "whisper-large", "whisper-test"])
    p.add_argument("--encoder_layer", type=int, default=-1,
                   help="Encoder layer tapped for the features: -1 (the final "
                        "post-LN output, the JAX script's default, kept for "
                        "parity) or k >= 0 (the first k+1 layers; "
                        "LID_BENCH.json's sweep picked 3)")
    # Classifier
    p.add_argument("--hidden_dims", type=int, nargs="+", default=[256, 128])
    p.add_argument("--dropout", type=float, default=0.3)
    p.add_argument("--pooling", type=str, default="mean",
                   choices=["mean", "max", "attention"])
    p.add_argument("--use_cnn", action="store_true")
    p.add_argument("--label_smoothing", type=float, default=0.1)
    # Data
    p.add_argument("--languages", type=str, nargs="+",
                   default=["hindi", "italian", "punjabi", "telugu"])
    p.add_argument("--data_sources", type=str, nargs="+",
                   default=["common_voice"])
    p.add_argument("--samples_per_language", type=int, default=5000)
    p.add_argument("--balanced", action="store_true", default=True)
    p.add_argument("--no_balanced", action="store_true")
    p.add_argument("--class_weights", type=str, default="none",
                   choices=["none", "inverse_freq", "inverse_sqrt",
                            "effective_samples"])
    p.add_argument("--class_weight_max", type=float, default=10.0)
    p.add_argument("--class_weight_smoothing", type=float, default=0.0)
    p.add_argument("--max_duration", type=float, default=15.0)
    p.add_argument("--min_duration", type=float, default=1.0)
    # Training
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--max_steps", type=int, default=2000)
    p.add_argument("--eval_steps", type=int, default=200)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--scheduler_type", type=str, default="cosine")
    p.add_argument("--mixed_precision", type=str, default="bf16",
                   choices=["no", "fp16", "bf16"])
    # Output / misc
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--wandb_project", type=str, default="lid-classifier")
    p.add_argument("--wandb_run_name", type=str, default=None)
    p.add_argument("--no_wandb", action="store_true")
    p.add_argument("--cache_dir", type=str, default=None,
                   help="not ported (no weight downloads)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--cache_features", action="store_true",
                   help="Precompute the frozen-encoder features once (from "
                        "loaders that drop no sample) and train the head on "
                        "the device-resident cache, [N, T_enc, d_model] in "
                        "the compute dtype; one microbatch per step")
    p.add_argument("--resume_from", type=str, default=None,
                   help="Checkpoint dir (an output_dir or its classifier/ "
                        "subdir) to resume from")
    p.add_argument("--dp", type=int, default=1,
                   help="Data-parallel mesh axis (batch shards over it); "
                        "one process per device, launched with torchrun")
    p.add_argument("--tp", type=int, default=1,
                   help="Tensor-parallel mesh axis for the frozen encoder "
                        "(must divide its heads)")
    p.add_argument("--dcn_dp", type=int, default=1,
                   help="Data-parallel replicas across nodes (adds a leading "
                        "'replica' mesh axis)")
    p.add_argument("--platform", type=str, default="auto",
                   choices=["auto", "cpu", "tpu"], help="not ported: use --device")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.platform != "auto":
        p.error(f"--platform {args.platform}: not ported to sar_tpu_torch "
                f"(use --device)")
    if args.cache_dir is not None:
        p.error("--cache_dir: not ported to sar_tpu_torch (real Whisper weights "
                "wait for files in the repository)")
    if args.data_sources != ["synthetic"]:
        p.error(f"--data_sources {' '.join(args.data_sources)}: sar_tpu_torch "
                f"has the 'synthetic' source only; the real corpora wait for "
                f"data in the repository")
    if args.cache_features and args.gradient_accumulation_steps != 1:
        p.error(f"--cache_features trains one microbatch per step; "
                f"--gradient_accumulation_steps "
                f"{args.gradient_accumulation_steps} would not be honoured "
                f"(drop one of the two)")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    from sar_tpu_torch.data import DataLoader, LIDCollator, create_dataset
    from sar_tpu_torch.device import resolve_device
    from sar_tpu_torch.models import classifier as clf
    from sar_tpu_torch.models.base import load_base_model
    from sar_tpu_torch.training import WandbCallback
    from sar_tpu_torch.parallel.distributed import (is_main_process,
                                                    maybe_initialize_distributed)
    from sar_tpu_torch.parallel.sharding import mesh_device, mesh_from_flags
    from sar_tpu_torch.training.lid_trainer import (LIDDataset, LIDTrainer,
                                                    LIDTrainingArgs)

    maybe_initialize_distributed(device=args.device)
    mesh = mesh_from_flags(args.dp, args.tp, args.dcn_dp)
    if not is_main_process():
        logging.getLogger().setLevel(logging.WARNING)     # rank 0 logs
    device = resolve_device(args.device) if mesh is None else mesh_device(mesh)
    main_rank = is_main_process()
    out = Path(args.output_dir)
    if main_rank:
        out.mkdir(parents=True, exist_ok=True)
        (out / "config.yaml").write_text(
            "\n".join(f"{k}: {json.dumps(v)}" for k, v in sorted(vars(args).items()))
            + "\n")

    dtype = torch.float32 if args.mixed_precision == "no" else torch.bfloat16
    cfg, params = load_base_model(args.base_model, dtype=dtype, device=device)

    def build(split):
        return {lang: create_dataset(language=lang, sources=args.data_sources,
                                     split=split, language_id=i, seed=args.seed,
                                     model_config=cfg)
                for i, lang in enumerate(args.languages)}

    # Explicit class weights turn undersampling off unless it is forced.
    use_weights = args.class_weights != "none"
    balance = args.balanced and not args.no_balanced and not use_weights
    train_lid = LIDDataset(build("train"), args.languages,
                           samples_per_language=args.samples_per_language,
                           balance=balance, seed=args.seed)
    val_lid = LIDDataset(build("validation"), args.languages,
                         samples_per_language=max(args.samples_per_language // 10, 1),
                         balance=False, seed=args.seed)

    class_weights = None
    if use_weights:
        w = clf.compute_class_weights_from_counts(
            train_lid.class_counts, args.languages, strategy=args.class_weights,
            max_weight=args.class_weight_max,
            smoothing=args.class_weight_smoothing)
        class_weights = tuple(float(x) for x in w)
        logger.info("class weights: %s", dict(zip(args.languages, class_weights)))

    ccfg = clf.ClassifierConfig(
        input_dim=clf.get_hidden_dim(cfg), hidden_dims=tuple(args.hidden_dims),
        num_classes=len(args.languages), dropout=args.dropout,
        pooling=args.pooling, use_cnn=args.use_cnn,
        label_smoothing=args.label_smoothing, languages=tuple(args.languages),
        class_weights=class_weights, encoder_layer=args.encoder_layer)
    clf_params = clf.init_classifier(torch.Generator().manual_seed(args.seed), ccfg)

    coll = LIDCollator(num_mels=cfg.num_mel_bins, num_frames=cfg.num_audio_frames,
                       device=device)
    train_loader = DataLoader(train_lid, args.batch_size, coll, seed=args.seed)
    eval_loader = DataLoader(val_lid, args.batch_size, coll, shuffle=False,
                             drop_last=False)

    callbacks = []
    if not args.no_wandb and main_rank:
        callbacks.append(WandbCallback(project=args.wandb_project,
                                       name=args.wandb_run_name, config=vars(args)))
    targs = LIDTrainingArgs(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, max_steps=args.max_steps,
        eval_steps=args.eval_steps, scheduler=args.scheduler_type,
        mixed_precision=args.mixed_precision,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        encoder_layer=args.encoder_layer, seed=args.seed, device=str(device))
    trainer = LIDTrainer(cfg, params, clf_params, ccfg, targs, callbacks=callbacks,
                         mesh=mesh)
    if mesh is not None:
        logger.info("LID training on mesh %s", mesh)
    if args.resume_from:
        trainer.load_checkpoint(args.resume_from)
        logger.info("resumed from %s at step %d", args.resume_from,
                    trainer.global_step)
    if args.cache_features:
        logger.info("precomputing frozen-encoder features (layer %d) ...",
                    args.encoder_layer)
        every = DataLoader(train_lid, args.batch_size, coll, shuffle=False,
                           drop_last=False)
        tr_feats, tr_labels = trainer.precompute_features(every)
        ev_feats, ev_labels = trainer.precompute_features(eval_loader)
        logger.info("cached %d train / %d eval feature rows on the device",
                    tr_feats.shape[0], ev_feats.shape[0])
        history = trainer.train_cached(tr_feats, tr_labels, batch_size=args.batch_size,
                                       eval_feats=ev_feats, eval_labels=ev_labels)
    else:
        history = trainer.train(train_loader, eval_loader)

    if not main_rank:
        return history
    trainer.save_checkpoint(out / "classifier")
    (out / "history.json").write_text(json.dumps(
        {"loss": history["loss"][-50:], "eval": history["eval"]}, indent=2))
    final = history["eval"][-1] if history["eval"] else {}
    logger.info("done; accuracy=%.4f -> %s", final.get("accuracy", float("nan")),
                out / "classifier")
    return history


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    main()
