"""LID (language-identification) classifier trainer, the paper's Phase 2
(counterpart of sar_tpu/training/lid_trainer.py).

- `LIDDataset`: per-language ASR datasets -> (features, class label)
  samples, with per-language caps, undersampling to the smallest class
  (`balance`) and the class counts;
- `LIDTrainer`: a step runs the FROZEN encoder (`classifier.encode_features`
  at the tap layer, under no_grad: kernel K1 on the card) and then the
  classifier, over `gradient_accumulation_steps` microbatches whose
  gradients are averaged, then global-norm clipping and AdamW on the
  schedules of training/optim.py; `evaluate` reports loss, accuracy,
  per-class accuracy and the confusion matrix.
- The frozen-feature cache: the encoder never trains, so its features are
  constant over a run. `precompute_features` runs it once over a loader
  and keeps [N, T, d] on the device (in the compute dtype);
  `train_cached` / `evaluate_cached` train and evaluate the head on
  indexed slices of it. `train_cached` implements one microbatch per step
  and refuses gradient_accumulation_steps > 1 (the JAX package runs such a
  config at 1 silently); `evaluate_cached` reads the classifier's config
  at each call, so it follows a `load_checkpoint`.
- Checkpoints: the classifier directory (`save_classifier`, the format the
  JAX package shares) plus the training state as a torch file,
  `train_state.pt` (optimizer moments and count, global_step,
  best_metric). JAX's Orbax train state is not read.

The classifier's dropout draws from a torch generator seeded with
`args.seed` (JAX draws from jax.random), so losses equal the JAX
trainer's only with dropout 0. The head trains in fp32; the base model is
frozen in the compute dtype. The trainer runs on the CUDA card unless
`LIDTrainingArgs.device` says otherwise.

`mesh` (parallel/sharding.py, one process per rank): the frozen encoder
runs tensor and data parallel on this rank's shard of the weights and
rows of each batch, with exact attention (as the JAX trainer under a
mesh); the head is replicated, its loss is this rank's share of the
global batch's (weighted) mean, and its gradients are summed over the
batch shards, so AdamW runs identically on every rank. Evaluation pads a
partial batch to the batch shards and gathers the logits, so the metrics
are the whole batch's. The feature cache is a single-process path and
refuses a mesh, as in the JAX package. Only rank 0 writes checkpoints.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path

import numpy as np
import torch

from sar_tpu_torch.device import resolve_device, tree_to
from sar_tpu_torch.models import classifier as clf
from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import WhisperConfig
from sar_tpu_torch.models.whisper import tree_leaves, tree_map
from sar_tpu_torch.parallel import distributed as pdist
from sar_tpu_torch.parallel import sharding
from sar_tpu_torch.training.optim import apply_updates, make_optimizer

logger = logging.getLogger(__name__)


class LIDDataset:
    """Combine per-language datasets into (features, label) samples.

    `datasets` maps language name -> list-like ASR dataset (items carry
    "input_features"). Each language's items are shuffled by
    `np.random.default_rng(seed)`, capped at `samples_per_language`, and
    with `balance` cut to the smallest language's count."""

    def __init__(self, datasets: dict[str, object],
                 languages: list[str] | tuple[str, ...],
                 samples_per_language: int | None = None,
                 balance: bool = False, seed: int = 42):
        self.languages = list(languages)
        rng = np.random.default_rng(seed)
        per_lang: dict[str, list[int]] = {}
        for lang in self.languages:
            idx = np.arange(len(datasets[lang]))
            rng.shuffle(idx)
            if samples_per_language is not None:
                idx = idx[:samples_per_language]
            per_lang[lang] = idx.tolist()
        if balance:
            n_min = min(len(v) for v in per_lang.values())
            per_lang = {k: v[:n_min] for k, v in per_lang.items()}
        self._entries = [(lang, i, li) for li, lang in enumerate(self.languages)
                         for i in per_lang[lang]]
        self._datasets = datasets
        self.class_counts = {lang: len(per_lang[lang]) for lang in self.languages}
        logger.info("LID dataset class distribution: %s", self.class_counts)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        lang, j, li = self._entries[i]
        return {"input_features": self._datasets[lang][j]["input_features"],
                "language_id": li}


@dataclasses.dataclass
class LIDTrainingArgs:
    """The JAX package's defaults, plus `device` (None: the CUDA card)."""
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    warmup_steps: int = 100
    max_steps: int = 2000
    eval_steps: int = 200
    scheduler: str = "cosine"
    mixed_precision: str = "bf16"
    gradient_accumulation_steps: int = 1
    max_grad_norm: float = 1.0
    encoder_layer: int = -1          # the encoder layer tapped (-1: the final output)
    seed: int = 42
    device: str | None = None


class LIDTrainer:
    """Trains a LID head on frozen Whisper encoder features."""

    def __init__(self, model_cfg: WhisperConfig, base_params: dict,
                 clf_params: dict, clf_cfg: clf.ClassifierConfig,
                 args: LIDTrainingArgs | None = None,
                 callbacks: list | None = None, mesh=None):
        self.cfg = model_cfg
        self.clf_cfg = clf_cfg
        self.args = args or LIDTrainingArgs()
        if clf_cfg.encoder_layer != self.args.encoder_layer:
            raise ValueError(
                f"ClassifierConfig.encoder_layer={clf_cfg.encoder_layer} != "
                f"LIDTrainingArgs.encoder_layer={self.args.encoder_layer}; "
                "the tap layer is saved with the classifier so inference "
                "extracts the features the head was trained on — set both "
                "to the same value")
        self.callbacks = callbacks or []
        self.mesh = mesh
        self.tp = sharding.model_group(mesh)
        self.device = (resolve_device(self.args.device) if mesh is None
                       else sharding.mesh_device(mesh))
        self.compute_dtype = (torch.bfloat16
                              if self.args.mixed_precision in ("bf16", "fp16")
                              else torch.float32)
        base = tree_to(base_params, self.device)
        base = (whisper.cast_params(base, self.compute_dtype)
                if self.compute_dtype != torch.float32 else base)
        self.base_params = (base if mesh is None
                            else sharding.shard_params(base, mesh, model_cfg))
        self.params = self._masters(clf_params)
        self.tx, self.schedule = make_optimizer(
            learning_rate=self.args.learning_rate,
            weight_decay=self.args.weight_decay,
            warmup_steps=self.args.warmup_steps,
            max_steps=self.args.max_steps,
            scheduler=self.args.scheduler,
            max_grad_norm=self.args.max_grad_norm)
        self.opt_state = self.tx.init(self.params)
        self.global_step = 0
        self.best_metric: float | None = None
        # The encoder attention kernel K1 on the card, exact attention on
        # the CPU and under a mesh (as the JAX trainer).
        self.flash = "hm" if self.device.type == "cuda" and mesh is None else False
        self._gen = torch.Generator(device=self.device).manual_seed(self.args.seed)

    def _masters(self, params: dict) -> dict:
        """fp32 copies of the head's params on the device, requiring grad."""
        return tree_map(lambda x: x.detach().to(self.device, torch.float32)
                        .clone().requires_grad_(True), params)

    # ------------------------------------------------------------------
    def features(self, mel) -> torch.Tensor:
        """The frozen encoder's features of a batch of log-mel features at
        the tap layer, in the compute dtype (under a mesh, of the rows this
        rank was given)."""
        mel = torch.as_tensor(mel).to(self.device, self.compute_dtype)
        return clf.encode_features(self.base_params, mel, self.cfg,
                                   layer_index=self.args.encoder_layer,
                                   flash=self.flash, tp=self.tp)

    def _labels(self, labels) -> torch.Tensor:
        return pdist.as_tensor(labels).to(self.device).long()

    def _rows(self, x):
        """This rank's rows of a global batch array under a mesh (all of it
        otherwise), on the device."""
        x = pdist.as_tensor(x)
        if self.mesh is None:
            return x.to(self.device)
        return pdist.put_global_batch(x, self.mesh, device=self.device)

    def _update(self, losses_and_grads: list) -> torch.Tensor:
        """Average the microbatches' (loss, grads), clip, AdamW; -> mean loss."""
        A = len(losses_and_grads)
        grads = tree_map(lambda *g: sum(g) / A, *[g for _, g in losses_and_grads])
        updates, self.opt_state = self.tx.update(grads, self.opt_state, self.params)
        apply_updates(self.params, updates)
        return sum(l for l, _ in losses_and_grads) / A

    def _loss_and_grads(self, feats: torch.Tensor, labels: torch.Tensor,
                        rows: tuple[int, int, int] | None = None):
        """(loss, head gradients) of a microbatch; under a mesh `feats` and
        `labels` are this rank's `rows` (lo, hi, n) of it, and the loss
        and gradients are the whole microbatch's."""
        leaves = tree_leaves(self.params)
        loss = clf.apply_classifier(self.params, self.clf_cfg, feats, labels=labels,
                                    train=True, generator=self._gen,
                                    rows=rows)["loss"]
        if self.mesh is not None:
            # This rank's share of the global mean: local num / global den.
            den = clf.loss_weight(labels, self.clf_cfg)
            loss = loss * (den / sharding.batch_sum(den, self.mesh))
        grads = torch.autograd.grad(loss, leaves)
        if self.mesh is not None:
            grads = sharding.reduce_gradients(list(grads), self.mesh)
            loss = sharding.batch_sum(loss.detach(), self.mesh)
        grads = iter(grads)
        return loss.detach(), tree_map(lambda _: next(grads), self.params)

    def _micro(self, b: dict):
        n = len(b["language_ids"])
        rows = None
        if self.mesh is not None:
            r = pdist.global_batch_sharding(self.mesh, n)
            rows = (r.start, r.stop, n)
        return self._loss_and_grads(self.features(self._rows(b["input_features"])),
                                    self._rows(b["language_ids"]).long(), rows)

    def train_step(self, micro: list[dict]) -> torch.Tensor:
        """One optimizer update over the microbatches `micro` (collated
        batches with "input_features" and "language_ids") -> mean loss."""
        return self._update([self._micro(b) for b in micro])

    def _log_step(self, history: dict, loss, t0: float, every: int, tag: str) -> None:
        self.global_step += 1
        logs = {"loss": float(loss),
                "learning_rate": self.schedule(self.global_step)}
        history["loss"].append(logs["loss"])
        for cb in self.callbacks:
            cb.on_step_end(self, self.global_step, logs)
        if self.global_step % every == 0 or self.global_step == 1:
            logger.info("LID step %d/%d loss=%.4f (%.2f steps/s%s)",
                        self.global_step, self.args.max_steps, logs["loss"],
                        self.global_step / (time.time() - t0), tag)

    def _should_stop(self) -> bool:
        return any(getattr(cb, "should_stop", False) for cb in self.callbacks)

    def train(self, train_loader, eval_loader=None) -> dict:
        """Streaming training: the encoder runs on every microbatch."""
        args = self.args
        for cb in self.callbacks:
            cb.on_train_begin(self)
        history: dict = {"loss": [], "eval": []}
        if eval_loader is not None:
            history["eval"].append({"step": 0, **self.evaluate(eval_loader)})
        it = train_loader.iterate()
        t0 = time.time()
        while self.global_step < args.max_steps:
            micro = [next(it) for _ in range(args.gradient_accumulation_steps)]
            self._log_step(history, self.train_step(micro), t0, 50, "")
            if eval_loader is not None and args.eval_steps \
                    and self.global_step % args.eval_steps == 0:
                history["eval"].append({"step": self.global_step,
                                        **self.evaluate(eval_loader)})
                if self._should_stop():
                    break
        for cb in self.callbacks:
            cb.on_train_end(self)
        return history

    # ------------------------------------------------------------------
    @torch.no_grad()
    def precompute_features(self, loader) -> tuple[torch.Tensor, torch.Tensor]:
        """The frozen encoder once over one epoch of `loader` -> (feats
        [N, T, d] in the compute dtype, labels [N] int64), on the device.
        Features depend on the tap layer, not on the head, so one cache
        serves every head at that layer. Give it a loader that drops no
        sample (drop_last=False) to cache the whole split. A single-process
        path: a mesh is refused, as in the JAX package."""
        self._refuse_mesh()
        feats, labels = [], []
        for batch in loader.one_epoch():
            feats.append(self.features(batch["input_features"]))
            labels.append(self._labels(batch["language_ids"]))
        return torch.cat(feats), torch.cat(labels)

    def train_cached(self, feats: torch.Tensor, labels: torch.Tensor,
                     batch_size: int = 32, eval_feats=None,
                     eval_labels=None) -> dict:
        """train(), over a feature cache from precompute_features: one
        microbatch per step, drawn from host-side permutations of the cache
        (`np.random.default_rng(args.seed)`, epoch after epoch)."""
        self._refuse_mesh()
        args = self.args
        if args.gradient_accumulation_steps != 1:
            raise ValueError(
                f"train_cached takes one microbatch per step; "
                f"gradient_accumulation_steps={args.gradient_accumulation_steps} "
                f"would not be honoured (use train(), or 1)")
        n = int(feats.shape[0])
        rng = np.random.default_rng(args.seed)
        perm: list[int] = []
        for cb in self.callbacks:
            cb.on_train_begin(self)
        history: dict = {"loss": [], "eval": []}
        if eval_feats is not None:
            history["eval"].append(
                {"step": 0, **self.evaluate_cached(eval_feats, eval_labels)})
        t0 = time.time()
        while self.global_step < args.max_steps:
            if len(perm) < batch_size:
                perm.extend(rng.permutation(n).tolist())
            idx = torch.as_tensor(perm[:batch_size], device=feats.device)
            del perm[:batch_size]
            loss = self._update([self._loss_and_grads(feats[idx], labels[idx])])
            self._log_step(history, loss, t0, 100, ", cached")
            if eval_feats is not None and args.eval_steps \
                    and self.global_step % args.eval_steps == 0:
                history["eval"].append(
                    {"step": self.global_step,
                     **self.evaluate_cached(eval_feats, eval_labels)})
                if self._should_stop():
                    break
        for cb in self.callbacks:
            cb.on_train_end(self)
        return history

    def _eval_batch(self, logits, labels, confusion, losses) -> None:
        """Add one batch's loss and its confusion counts."""
        labels = self._labels(labels)
        losses.append(float(clf.classifier_loss(logits, labels, self.clf_cfg)))
        np.add.at(confusion, (labels.cpu().numpy(), logits.argmax(-1).cpu().numpy()), 1)

    def _logits(self, mel) -> torch.Tensor:
        """The head's logits of a batch of log-mel features. Under a mesh the
        batch is padded to the batch shards, this rank's rows go through the
        encoder and the head, and the logits are gathered and cut to the
        batch (without one, the pad is empty and the gather is the rows)."""
        B = len(mel)
        feats = self.features(self._rows(pdist.pad_global_batch(mel, self.mesh)))
        logits = clf.apply_classifier(self.params, self.clf_cfg, feats)["logits"]
        return sharding.batch_gather(logits, self.mesh)[:B]

    @torch.no_grad()
    def evaluate_cached(self, feats: torch.Tensor, labels: torch.Tensor,
                        batch_size: int = 64) -> dict:
        """evaluate(), over a feature cache."""
        self._refuse_mesh()
        for cb in self.callbacks:
            cb.on_evaluate_begin(self)
        K = self.clf_cfg.num_classes
        confusion = np.zeros((K, K), np.int64)
        losses: list[float] = []
        for s in range(0, int(feats.shape[0]), batch_size):
            logits = clf.apply_classifier(self.params, self.clf_cfg,
                                          feats[s:s + batch_size])["logits"]
            self._eval_batch(logits, labels[s:s + batch_size], confusion, losses)
        metrics = self._lid_metrics(confusion, losses)
        for cb in self.callbacks:
            cb.on_evaluate_end(self, metrics)
        return metrics

    def _refuse_mesh(self) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                "feature caching is a single-host fast path; under a mesh "
                "use the streaming train() (encoder cost is sharded there)")

    @torch.no_grad()
    def evaluate(self, eval_loader) -> dict:
        """Loss, accuracy, per-class accuracy and the confusion matrix over
        one epoch of `eval_loader`."""
        for cb in self.callbacks:
            cb.on_evaluate_begin(self)
        K = self.clf_cfg.num_classes
        confusion = np.zeros((K, K), np.int64)
        losses: list[float] = []
        for batch in eval_loader.one_epoch():
            self._eval_batch(self._logits(batch["input_features"]),
                             batch["language_ids"], confusion, losses)
        metrics = self._lid_metrics(confusion, losses)
        for cb in self.callbacks:
            cb.on_evaluate_end(self, metrics)
        return metrics

    def _lid_metrics(self, confusion: np.ndarray, losses: list) -> dict:
        total = confusion.sum()
        acc = float(np.trace(confusion)) / max(total, 1)
        per_class = {lang: float(confusion[i, i]) / max(confusion[i].sum(), 1)
                     for i, lang in enumerate(self.clf_cfg.languages)}
        metrics = {"eval_loss": float(np.mean(losses)) if losses else float("nan"),
                   "accuracy": acc, "per_class_accuracy": per_class,
                   "confusion_matrix": confusion.tolist(),
                   "num_samples": int(total)}
        logger.info("LID eval @ %d: acc=%.4f per-class=%s", self.global_step,
                    round(acc, 4), {k: round(v, 3) for k, v in per_class.items()})
        return metrics

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str | Path) -> None:
        """The classifier directory (params + config) and train_state.pt
        (optimizer state, global_step, best_metric); rank 0 alone writes."""
        if not pdist.is_main_process():
            return
        path = Path(path)
        clf.save_classifier(path, self.params, self.clf_cfg,
                            metadata={"global_step": self.global_step,
                                      "model": self.cfg.name})
        cpu = lambda x: x.detach().cpu()
        torch.save({"opt_state": {"count": int(self.opt_state["count"]),
                                  "mu": tree_map(cpu, self.opt_state["mu"]),
                                  "nu": tree_map(cpu, self.opt_state["nu"])},
                    "global_step": self.global_step,
                    "best_metric": self.best_metric},
                   path / "train_state.pt")

    def load_checkpoint(self, path: str | Path) -> None:
        """Restore the classifier (weights and config) and, when saved, the
        optimizer state, the step and the best metric (`--resume_from`).
        `path` is a classifier directory or a train_router output root."""
        path = Path(path)
        if (path / "classifier").exists():
            path = path / "classifier"
        params, ccfg, _ = clf.load_classifier(path, self.device)
        if ccfg.encoder_layer != self.args.encoder_layer:
            raise ValueError(
                f"checkpoint was trained at encoder_layer={ccfg.encoder_layer} "
                f"but --encoder_layer is {self.args.encoder_layer}; resume "
                f"with the matching value")
        self.clf_cfg = ccfg
        self.params = self._masters(params)
        self.opt_state = self.tx.init(self.params)
        if (path / "train_state.pt").exists():
            state = torch.load(path / "train_state.pt", map_location=self.device,
                               weights_only=True)
            self.opt_state = state["opt_state"]
            self.global_step = int(state["global_step"])
            self.best_metric = state["best_metric"]
