"""LoRA trainer (counterpart of sar_tpu/training/trainer.py::ASRTrainer).

Step-based training to `max_steps` with an initial evaluation at step 0,
gradient accumulation over `gradient_accumulation_steps` microbatches
(gradients averaged), global-norm clipping and AdamW on the schedules of
training/optim.py, periodic evaluation (teacher-forced loss plus greedy
generation and WER/CER), callback hooks, early stopping and checkpoints. A
training "step" is an optimizer update.

The base model is frozen in the compute dtype (bf16 for mixed_precision
"bf16" or "fp16", else as given) with fp32 LoRA masters, which
`lora_delta` casts to the compute dtype. On the card the three attentions
of a step (encoder self, decoder causal self, decoder cross) run through
kernel K6, forward and backward (`flash_attention="auto"`), and each layer
is checkpointed (`gradient_checkpointing`) with a policy that saves the
plain matmuls and K6's output, so the backward reruns no attention
(models/whisper.py::_remat). LoRA dropout masks come from a seed per
microbatch (the step and microbatch folded into `seed`), folded per side,
layer and hook, so the recompute draws the same masks.

The evaluation decodes through the unquantized classic cache, as the JAX
trainer's `greedy_decode` defaults do, and its encoder takes K6's forward
on the card; its teacher-forced decoder takes exact attention, as there.
The trainer runs on the CUDA card unless `TrainingArgs.device` says
otherwise (sar_tpu_torch/device.py).

`mesh` (parallel/sharding.py, one process per rank) trains data and
tensor parallel: the base weights are this rank's shard (`shard_params`),
the bank is replicated, and each microbatch keeps this rank's rows of the
global batch every rank loaded (`put_global_batch`). The loss of a
microbatch is its global mean: the local sum over the all-reduced global
token count, so shards holding different numbers of label tokens weigh
as they should. The gradients are reduced over the mesh
(`reduce_gradients`), so clipping and AdamW run identically on every
rank. LoRA dropout masks are the global batch's at this rank's rows
(`dropout_rows`), as on one device. Evaluation pads a partial batch to
the batch shards and gathers the tokens. Only rank 0 writes checkpoints.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from sar_tpu_torch.decode.greedy import greedy_decode, transcribe_tokens
from sar_tpu_torch.device import resolve_device, tree_to
from sar_tpu_torch.models import lora as lora_lib
from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import WhisperConfig
from sar_tpu_torch.models.whisper import tree_leaves, tree_map
from sar_tpu_torch.parallel import distributed as pdist
from sar_tpu_torch.parallel import sharding
from sar_tpu_torch.training import checkpoints
from sar_tpu_torch.training.metrics import compute_metrics
from sar_tpu_torch.training.optim import (apply_updates, global_norm,
                                          make_optimizer)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainingArgs:
    """The JAX package's defaults, plus `device` (None: the CUDA card)."""
    learning_rate: float = 5e-4
    weight_decay: float = 0.01
    warmup_steps: int = 500
    max_steps: int = 5000
    eval_steps: int = 1000
    scheduler: str = "linear"              # linear | cosine | constant
    mixed_precision: str = "bf16"          # bf16 | fp16 (-> bf16) | no
    gradient_accumulation_steps: int = 4
    max_grad_norm: float = 1.0
    max_new_tokens: int = 256
    gradient_checkpointing: bool = True
    # Blockwise attention K6 (ops/flash.py): "auto" = on on the CUDA card,
    # off on the CPU (its plain version materialises the scores anyway);
    # "on"/"off" force it. The kernel takes bf16 only, so an fp32 run
    # (mixed_precision "no") on the card raises unless given "off".
    flash_attention: str = "auto"
    seed: int = 42
    device: str | None = None

    def compute_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.mixed_precision in ("bf16", "fp16")
                else torch.float32)

    def resolve_flash(self, device: torch.device) -> bool:
        if self.flash_attention == "auto":
            return device.type == "cuda"
        if self.flash_attention not in ("on", "off"):
            raise ValueError(f"flash_attention={self.flash_attention!r}: "
                             f"auto, on or off")
        return self.flash_attention == "on"


class ASRTrainer:
    """Trains a LoRA adapter (bank) on a frozen Whisper base."""

    def __init__(self, model_cfg: WhisperConfig, base_params: dict,
                 lora: dict, lora_cfg: lora_lib.LoraConfig,
                 args: TrainingArgs | None = None, tokenizer=None,
                 language: str = "hindi", languages: list | None = None,
                 callbacks: list | None = None, mesh=None):
        self.cfg = model_cfg
        self.args = args or TrainingArgs()
        self.lora_cfg = lora_cfg
        self.tokenizer = tokenizer
        self.language = language
        # Bank order: index i of `languages` = adapter i = language_ids i.
        self.languages = list(languages) if languages else [language]
        self.callbacks = callbacks or []
        self.mesh = mesh
        self.tp = sharding.model_group(mesh)
        self.device = (resolve_device(self.args.device) if mesh is None
                       else sharding.mesh_device(mesh))
        self.compute_dtype = self.args.compute_dtype()
        base = tree_to(base_params, self.device)
        base = (whisper.cast_params(base, self.compute_dtype)
                if self.compute_dtype != torch.float32 else base)
        self.base_params = (base if mesh is None
                            else sharding.shard_params(base, mesh, model_cfg))
        self.lora = self._masters(lora)
        self.tx, self.schedule = make_optimizer(
            learning_rate=self.args.learning_rate,
            weight_decay=self.args.weight_decay,
            warmup_steps=self.args.warmup_steps,
            max_steps=self.args.max_steps,
            scheduler=self.args.scheduler,
            max_grad_norm=self.args.max_grad_norm)
        self.opt_state = self.tx.init(self.lora)
        self.multi_adapter = lora_lib.num_adapters(self.lora) > 1
        self.flash = self.args.resolve_flash(self.device)
        self.global_step = 0
        self.epoch = 0
        self.best_metric: float | None = None

    def _masters(self, lora: dict) -> dict:
        """fp32 copies of a bank on the trainer's device, requiring grad."""
        return tree_map(lambda x: x.detach().to(self.device, torch.float32)
                        .clone().requires_grad_(True), lora)

    # ------------------------------------------------------------------
    def _put(self, x, dtype=None) -> torch.Tensor:
        """A batch array on the device: this rank's rows under a mesh."""
        x = pdist.as_tensor(x)
        if self.mesh is not None:
            x = pdist.put_global_batch(x, self.mesh, device=self.device)
        return x.to(self.device, dtype)

    def _batch(self, batch: dict):
        """(mel in the compute dtype, labels int64, adapter index or None,
        the dropout rows) of a collated batch, on the device: under a mesh
        this rank's rows, with (lo, hi, global rows)."""
        n = len(batch["labels"])
        mel = self._put(batch["input_features"], self.compute_dtype)
        labels = self._put(batch["labels"]).long()
        ids = self._put(batch.get("language_ids", np.zeros(n, np.int32))).long()
        rows = None
        if self.mesh is not None:
            r = pdist.global_batch_sharding(self.mesh, n)
            rows = (r.start, r.stop, n)
        return mel, labels, (ids if self.multi_adapter else None), rows

    def _loss(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The cross entropy over the batch's label tokens: under a mesh this
        rank's share of the global mean (its sum over the global count)."""
        if self.mesh is None:
            return whisper.cross_entropy_loss(logits, labels)
        count = sharding.batch_sum((labels != -100).sum().float(), self.mesh)
        return whisper.cross_entropy_loss(logits, labels, count=count)

    def microbatch_loss(self, batch: dict, seed: int | None) -> torch.Tensor:
        """The teacher-forced loss of one microbatch, with LoRA dropout
        drawn from `seed`, as a graph to differentiate (under a mesh, this
        rank's share: `_loss`)."""
        mel, labels, idx, rows = self._batch(batch)
        dec_in = whisper.shift_tokens_right(labels, self.cfg.sot_token_id,
                                            self.cfg.pad_token_id)
        logits = whisper.forward(
            self.base_params, mel, dec_in, self.cfg, lora=self.lora,
            adapter_idx=idx, lora_scale=self.lora_cfg.scale,
            lora_dropout=self.lora_cfg.dropout, dropout_seed=seed,
            remat=self.args.gradient_checkpointing, flash=self.flash,
            tp=self.tp, dropout_rows=rows)
        return self._loss(logits, labels)

    def lora_grads(self, batch: dict, seed: int | None):
        """(loss, gradients of the LoRA masters as a tree) of a microbatch;
        under a mesh the global loss and the reduced gradients."""
        params = tree_leaves(self.lora)
        loss = self.microbatch_loss(batch, seed)
        grads = torch.autograd.grad(loss, params)
        if self.mesh is not None:
            grads = sharding.reduce_gradients(list(grads), self.mesh)
            loss = sharding.batch_sum(loss.detach(), self.mesh)
        grads = iter(grads)
        return loss.detach(), tree_map(lambda _: next(grads), self.lora)

    def train_step(self, micro: list[dict]):
        """One optimizer update over the microbatches `micro`: gradients
        summed then averaged, clipped, AdamW. Returns (mean loss, global
        norm of the averaged gradients) as 0-dim tensors."""
        step_seed = whisper.fold_in(self.args.seed, self.global_step)
        loss_sum, g_sum = 0.0, None
        for i, batch in enumerate(micro):
            loss, g = self.lora_grads(batch, whisper.fold_in(step_seed, i))
            loss_sum = loss_sum + loss
            g_sum = g if g_sum is None else tree_map(torch.add, g_sum, g)
        A = len(micro)
        grads = tree_map(lambda x: x / A, g_sum)
        updates, self.opt_state = self.tx.update(grads, self.opt_state, self.lora)
        apply_updates(self.lora, updates)
        return loss_sum / A, global_norm(grads)

    # ------------------------------------------------------------------
    def train(self, train_loader, eval_loader=None) -> dict:
        args = self.args
        for cb in self.callbacks:
            cb.on_train_begin(self)

        history: dict[str, Any] = {"loss": [], "eval": [], "step_seconds": []}
        if eval_loader is not None:
            metrics = self.evaluate(eval_loader)
            history["eval"].append({"step": self.global_step, **metrics})

        batch_iter = train_loader.iterate()
        accum = args.gradient_accumulation_steps
        t0 = time.time()
        for cb in self.callbacks:
            cb.on_epoch_begin(self, self.epoch)
        while self.global_step < args.max_steps:
            loader_epoch = getattr(train_loader, "current_epoch", 0)
            if loader_epoch != self.epoch:
                for cb in self.callbacks:
                    cb.on_epoch_end(self, self.epoch)
                self.epoch = loader_epoch
                for cb in self.callbacks:
                    cb.on_epoch_begin(self, self.epoch)
            for cb in self.callbacks:
                cb.on_step_begin(self, self.global_step)
            micro = [next(batch_iter) for _ in range(accum)]
            t_step = time.perf_counter()
            loss, gnorm = self.train_step(micro)
            self.global_step += 1
            logs = {"loss": float(loss),           # waits for the step
                    "learning_rate": self.schedule(self.global_step),
                    "grad_norm": float(gnorm)}
            history["step_seconds"].append(time.perf_counter() - t_step)
            history["loss"].append(logs["loss"])
            for cb in self.callbacks:
                cb.on_step_end(self, self.global_step, logs)
            if self.global_step % 50 == 0 or self.global_step == 1:
                rate = self.global_step / (time.time() - t0)
                logger.info("step %d/%d loss=%.4f lr=%.2e (%.2f steps/s)",
                            self.global_step, args.max_steps, logs["loss"],
                            logs["learning_rate"], rate)

            if eval_loader is not None and args.eval_steps \
                    and self.global_step % args.eval_steps == 0:
                metrics = self.evaluate(eval_loader)
                history["eval"].append({"step": self.global_step, **metrics})
                if any(getattr(cb, "should_stop", False) for cb in self.callbacks):
                    logger.info("early stop at step %d", self.global_step)
                    break

        for cb in self.callbacks:
            cb.on_epoch_end(self, self.epoch)
            cb.on_train_end(self)
        return history

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval_batch(self, batch: dict, prompt_table: torch.Tensor):
        """(teacher-forced loss, greedy tokens [B, P + max_new_tokens]) of
        one batch: the encoder (K6 on the card), the decoder with exact
        attention, greedy over the unquantized cache. Under a mesh a
        partial batch is padded to the batch shards (rows of -100 labels,
        which weigh nothing), each rank runs its rows, and the loss and
        the tokens are those of the whole batch."""
        B = len(batch["labels"])
        mel, labels, idx, _ = self._batch(_pad_rows(batch, self.mesh))
        cfg, scale = self.cfg, self.lora_cfg.scale
        enc_out = whisper.encode(self.base_params, mel, cfg, lora=self.lora,
                                 adapter_idx=idx, lora_scale=scale,
                                 flash=self.flash, tp=self.tp)
        dec_in = whisper.shift_tokens_right(labels, cfg.sot_token_id,
                                            cfg.pad_token_id)
        logits = whisper.decode_train(self.base_params, enc_out, dec_in, cfg,
                                      lora=self.lora, adapter_idx=idx,
                                      lora_scale=scale, tp=self.tp)
        loss = self._loss(logits, labels)
        prompt = prompt_table[idx] if idx is not None else prompt_table[0]
        # Eager, not through a captured DecodeRunner: training moves the
        # bank between evaluations, and an evaluation decodes a few batches
        # of its own, so a graph captured per evaluation would cost more
        # (one eager pass + capture + instantiation per segment) than its
        # replays save.
        tokens = greedy_decode(self.base_params, enc_out, cfg, prompt,
                               max_new_tokens=self.args.max_new_tokens,
                               lora=self.lora, adapter_idx=idx,
                               lora_scale=scale, cross_kv_int8=False,
                               self_kv_int8=False, tp=self.tp)
        return (sharding.batch_sum(loss, self.mesh),
                sharding.batch_gather(tokens, self.mesh)[:B])

    def evaluate(self, eval_loader) -> dict:
        for cb in self.callbacks:
            cb.on_evaluate_begin(self)
        prompt_table = torch.tensor([self.cfg.prompt_ids(l) for l in self.languages],
                                    dtype=torch.int64, device=self.device)
        losses, preds, refs = [], [], []
        for batch in eval_loader.one_epoch():
            loss, tokens = self.eval_batch(batch, prompt_table)
            losses.append(float(loss))
            rows = transcribe_tokens(tokens, self.cfg,
                                     prompt_len=int(prompt_table.shape[1]))
            if self.tokenizer is not None:
                preds.extend(self.tokenizer.decode(row) for row in rows)
                refs.extend(batch["texts"])
        metrics = {"eval_loss": float(np.mean(losses)) if losses else float("nan"),
                   "num_samples": len(refs)}
        if preds:
            metrics.update(compute_metrics(preds, refs))
        logger.info("eval @ step %d: %s", self.global_step,
                    {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in metrics.items()})
        for cb in self.callbacks:
            cb.on_evaluate_end(self, metrics)
        return metrics

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str | Path) -> None:
        """The adapter, optimizer state and counters (rank 0 alone writes:
        every rank holds the same replicated state)."""
        if not pdist.is_main_process():
            return
        checkpoints.save_checkpoint(
            path, self.lora, self.lora_cfg, self.opt_state,
            self.global_step, self.epoch, self.best_metric,
            metadata={"language": self.language, "model": self.cfg.name})

    def load_checkpoint(self, path: str | Path) -> None:
        """Restore the adapter weights, the optimizer state, the step, the
        epoch and the best metric."""
        (lora, self.lora_cfg, _, opt_state, self.global_step, self.epoch,
         self.best_metric) = checkpoints.load_checkpoint(path, self.device)
        self.lora = self._masters(lora)
        self.opt_state = {"count": opt_state["count"],
                          "mu": tree_to(opt_state["mu"], self.device),
                          "nu": tree_to(opt_state["nu"], self.device)}
        self.multi_adapter = lora_lib.num_adapters(self.lora) > 1


def _pad_rows(batch: dict, mesh) -> dict:
    """A collated batch padded to the batch shards of `mesh` (as it is
    without one): zero features, -100 labels (no weight in the loss),
    adapter 0. Features and labels may be arrays or tensors on any device."""
    n = len(batch["labels"])
    return {**batch,
            "input_features": pdist.pad_global_batch(batch["input_features"], mesh),
            "labels": pdist.pad_global_batch(batch["labels"], mesh, -100),
            "language_ids": pdist.pad_global_batch(
                batch.get("language_ids", np.zeros(n, np.int32)), mesh)}
