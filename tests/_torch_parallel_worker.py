"""One rank of tests/test_torch_parallel.py's spawned world: the port's
data- and tensor-parallel paths over gloo on the CPU, on the inputs the
parent saved (`data.pt`), with every result written to `rank<r>.pt` for
the parent to compare against the JAX package's single-device results.
It imports torch and sar_tpu_torch only, so that each rank starts fast.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

LANGS = ["english", "german"]


def _trainer_run(cfg, params, bank, mesh, *, dropout=0.0, remat=False,
                 with_eval=False, max_steps=3, flash="auto"):
    from sar_tpu_torch.data import (CharTokenizer, DataLoader,
                                    SyntheticASRDataset, create_collator)
    from sar_tpu_torch.models import lora as tlora
    from sar_tpu_torch.training import ASRTrainer, TrainingArgs

    coll = create_collator(cfg.sot_token_id, pad_to_length=16)
    loader = DataLoader(SyntheticASRDataset(cfg, size=16, num_words=2, seed=5), 4,
                        coll, seed=7)
    # The eval features as a tensor, as the raw-audio collator gives them
    # (on its device).
    val = DataLoader(SyntheticASRDataset(cfg, size=6, num_words=2, seed=99), 4,
                     lambda items: _tensor_features(coll(items)),
                     shuffle=False, drop_last=False)
    args = TrainingArgs(learning_rate=3e-3, warmup_steps=1, max_steps=max_steps,
                        eval_steps=3 if with_eval else 0,
                        gradient_accumulation_steps=2, mixed_precision="no",
                        gradient_checkpointing=remat, max_new_tokens=6, seed=0,
                        flash_attention=flash, device="cpu")
    tr = ASRTrainer(cfg, params, bank, tlora.LoraConfig(r=4, alpha=8, dropout=dropout),
                    args, tokenizer=CharTokenizer(cfg), language="english", mesh=mesh)
    hist = tr.train(loader, val if with_eval else None)
    return {"loss": np.array(hist["loss"]),
            "bank": _numpy(tr.lora), "eval": hist["eval"]}


def _tensor_features(batch: dict) -> dict:
    return {**batch, "input_features": torch.as_tensor(batch["input_features"])}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _lid_run(cfg, params, clf_params, ccfg, mesh):
    from sar_tpu_torch.data import DataLoader, LIDCollator, SyntheticASRDataset
    from sar_tpu_torch.training.lid_trainer import (LIDDataset, LIDTrainer,
                                                    LIDTrainingArgs)

    ds = LIDDataset({l: SyntheticASRDataset(cfg, size=12, language=l, language_id=i,
                                            seed=i) for i, l in enumerate(LANGS)}, LANGS)
    loader = DataLoader(ds, 4, LIDCollator(), seed=3)
    evals = DataLoader(ds, 9, LIDCollator(), shuffle=False, drop_last=False)
    args = LIDTrainingArgs(learning_rate=5e-3, weight_decay=0.0, warmup_steps=2,
                           max_steps=4, eval_steps=4, scheduler="constant",
                           mixed_precision="no", gradient_accumulation_steps=2,
                           device="cpu")
    hist = LIDTrainer(cfg, params, clf_params, ccfg, args, mesh=mesh).train(loader, evals)
    return {"loss": np.array(hist["loss"]), "eval": hist["eval"][-1]}


def _cases(data: dict) -> dict:
    from sar_tpu_torch.data import CharTokenizer
    from sar_tpu_torch.decode.greedy import greedy_decode
    from sar_tpu_torch.evaluation.evaluator import ASREvaluator
    from sar_tpu_torch.models import whisper as tw
    from sar_tpu_torch.models.config import get_config
    from sar_tpu_torch.parallel import distributed as pdist
    from sar_tpu_torch.parallel import sharding

    cfg = get_config("whisper-test")
    cfg257 = dataclasses.replace(cfg, vocab_size=257)
    # Every rank builds the meshes in the same order (they make groups).
    meshes = {"d4m1": sharding.make_mesh(4, 1), "d2m2": sharding.make_mesh(2, 2),
              "d1m4": sharding.make_mesh(1, 4),
              "r2d1m2": pdist.make_multislice_mesh(dp=1, tp=2, replicas=2)}
    out: dict = {"axes": {k: pdist.axis_sizes(m) for k, m in meshes.items()},
                 "batch_shards": {k: pdist.n_batch_shards(m) for k, m in meshes.items()},
                 "rows": {k: tuple(pdist.global_batch_sharding(m, 8))
                          for k, m in meshes.items()}}
    params, mel, tokens = data["params"], data["mel"], data["tokens"]
    labels, bank = data["labels"], data["bank"]
    prompt = cfg.prompt_ids("english")

    def gather(x, mesh):
        return sharding.batch_gather(x.contiguous(), mesh)

    for name, mesh in meshes.items():
        tp = sharding.model_group(mesh)
        sp = sharding.shard_params(params, mesh, cfg)
        b = sharding.shard_batch({"mel": mel, "tokens": tokens, "labels": labels}, mesh)
        out[f"fwd_{name}"] = gather(tw.forward(sp, b["mel"], b["tokens"], cfg, tp=tp),
                                    mesh).numpy()
        if name == "d2m2":
            # The encoder through K1 ("hm", its plain version here: padded to
            # cross_pad_len) and through K6 (True, the decoder too), each on
            # this rank's heads.
            with torch.no_grad():
                for label, flash in (("hm", "hm"), ("k6", True)):
                    enc = tw.encode(sp, b["mel"], cfg, flash=flash, kernels=False, tp=tp)
                    out[f"fwd_{name}_{label}"] = gather(tw.decode_train(
                        sp, enc, b["tokens"], cfg, flash=flash is True, tp=tp),
                        mesh).numpy()
        if name in ("d2m2", "r2d1m2"):
            # The LoRA gradient of the global mean loss (the trainer's rule).
            lora = tw.tree_map(lambda x: x.clone().requires_grad_(True), bank)
            leaves = tw.tree_leaves(lora)
            dec_in = tw.shift_tokens_right(b["labels"], cfg.sot_token_id, cfg.pad_token_id)
            for remat in ((False, True) if name == "d2m2" else (False,)):
                logits = tw.forward(sp, b["mel"], dec_in, cfg, lora=lora, lora_scale=2.0,
                                    tp=tp, remat=remat)
                count = sharding.batch_sum((b["labels"] != -100).sum().float(), mesh)
                loss = tw.cross_entropy_loss(logits, b["labels"], count=count)
                grads = iter(sharding.reduce_gradients(
                    list(torch.autograd.grad(loss, leaves)), mesh))
                out[f"grad_{name}{'_remat' if remat else ''}"] = _numpy(
                    tw.tree_map(lambda _: next(grads), lora))
            with torch.no_grad():
                enc = tw.encode(sp, b["mel"], cfg, tp=tp)
                out[f"greedy_{name}"] = gather(greedy_decode(
                    sp, enc, cfg, prompt, max_new_tokens=8, tp=tp), mesh).numpy()

    # The odd vocabulary (257 rows dealt 65/64/64/64 over four ranks).
    mesh = meshes["d1m4"]
    tp = sharding.model_group(mesh)
    sp = sharding.shard_params(data["params257"], mesh, cfg257)
    out["v257_rows"] = sp["decoder"]["token_embed"].shape[0]
    out["fwd_v257"] = tw.forward(sp, mel, tokens, cfg257, tp=tp).numpy()
    with torch.no_grad():
        out["greedy_v257"] = greedy_decode(sp, tw.encode(sp, mel, cfg257, tp=tp), cfg257,
                                           prompt, max_new_tokens=8, tp=tp).numpy()

    # The entry points.
    for name in ("d2m2", "r2d1m2"):
        out[f"trainer_{name}"] = _trainer_run(cfg, data["tparams"], data["tbank"],
                                              meshes[name], with_eval=name == "d2m2")
    out["trainer_flash_d2m2"] = _trainer_run(cfg, data["tparams"], data["tbank"],
                                             meshes["d2m2"], flash="on")
    out["trainer_dropout_d2m2"] = _trainer_run(cfg, data["tparams"], data["tbank"],
                                               meshes["d2m2"], dropout=0.1, remat=True,
                                               max_steps=2)
    tok = CharTokenizer(cfg)
    for name, kw in (("d4m1", dict(kv_int8=False)), ("d2m2", {}), ("r2d1m2", {})):
        ev = ASREvaluator(cfg, data["tparams"], tok, language="english", max_new_tokens=8,
                          device="cpu", mesh=meshes[name], **kw)
        out[f"eval_{name}"] = ev._transcribe_batch(data["eval_mel"])
        out[f"eval_cache_{name}"] = tuple(ev.runner._cache.cross_k.shape)
    out["lid_d2m2"] = _lid_run(cfg, data["tparams"], data["clf_params"], data["ccfg"],
                               meshes["d2m2"])
    return out


def run(rank: int, world: int, workdir: str) -> None:
    """Rank `rank` of `world`: join the gloo group through a file under
    `workdir`, run the cases, write rank<r>.pt."""
    torch.set_num_threads(1)
    os.environ.pop("LOCAL_WORLD_SIZE", None)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        data = torch.load(os.path.join(workdir, "data.pt"), weights_only=False)
        out = _cases(data)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
