"""Training callbacks (a copy of sar_tpu/training/callbacks.py, which
imports no JAX; the port keeps its own).

The 8-hook Callback base, W&B logging, periodic + best-on-WER
checkpointing with a rolling limit, early stopping, and a TensorBoard
mirror through torch.utils.tensorboard. W&B and TensorBoard import lazily
and degrade to no-ops when they are not installed.
"""

from __future__ import annotations

import logging
import shutil
from pathlib import Path

logger = logging.getLogger(__name__)


class Callback:
    """Hook surface mirroring the reference's abstract Callback."""

    def on_train_begin(self, trainer): ...
    def on_train_end(self, trainer): ...
    def on_epoch_begin(self, trainer, epoch: int): ...
    def on_epoch_end(self, trainer, epoch: int): ...
    def on_step_begin(self, trainer, step: int): ...
    def on_step_end(self, trainer, step: int, logs: dict): ...
    def on_evaluate_begin(self, trainer): ...
    def on_evaluate_end(self, trainer, metrics: dict): ...


class WandbCallback(Callback):
    """W&B logging every `log_every` steps + eval metrics; lazy import,
    resume="allow" (parity with callbacks.py:49-120). No-op without wandb."""

    def __init__(self, project: str = "sar-tpu", name: str | None = None,
                 config: dict | None = None, log_every: int = 50):
        self.project, self.name, self.config = project, name, config or {}
        self.log_every = log_every
        self._run = None

    def on_train_begin(self, trainer):
        try:
            import wandb
        except ImportError:
            logger.warning("wandb not installed; WandbCallback is a no-op")
            return
        self._run = wandb.init(project=self.project, name=self.name,
                               config=self.config, resume="allow")

    def on_step_end(self, trainer, step, logs):
        if self._run and step % self.log_every == 0:
            self._run.log({"train/loss": logs.get("loss"),
                           "train/learning_rate": logs.get("learning_rate")},
                          step=step)

    def on_evaluate_end(self, trainer, metrics):
        if self._run:
            self._run.log({f"eval/{k}": v for k, v in metrics.items()},
                          step=trainer.global_step)

    def on_train_end(self, trainer):
        if self._run:
            self._run.finish()


class CheckpointCallback(Callback):
    """Periodic `step_N` checkpoints (rolling `save_total_limit`) plus a
    `best` checkpoint on the monitored metric; best is never pruned
    (parity with callbacks.py:123-218)."""

    def __init__(self, output_dir: str | Path, save_steps: int = 1000,
                 save_total_limit: int = 3, metric: str = "wer",
                 greater_is_better: bool = False):
        self.output_dir = Path(output_dir)
        self.save_steps = save_steps
        self.save_total_limit = save_total_limit
        self.metric = metric
        self.greater_is_better = greater_is_better
        self.best_value: float | None = None
        self._periodic: list[Path] = []

    def _improved(self, value: float) -> bool:
        if self.best_value is None:
            return True
        return value > self.best_value if self.greater_is_better \
            else value < self.best_value

    def on_step_end(self, trainer, step, logs):
        if self.save_steps and step > 0 and step % self.save_steps == 0:
            path = self.output_dir / f"step_{step}"
            trainer.save_checkpoint(path)
            self._periodic.append(path)
            while len(self._periodic) > self.save_total_limit:
                victim = self._periodic.pop(0)
                shutil.rmtree(victim, ignore_errors=True)
                logger.info("pruned checkpoint %s", victim)

    def on_evaluate_end(self, trainer, metrics):
        value = metrics.get(self.metric)
        if value is None:
            return
        if self._improved(float(value)):
            self.best_value = float(value)
            trainer.best_metric = self.best_value
            trainer.save_checkpoint(self.output_dir / "best")
            logger.info("new best %s=%.4f -> %s", self.metric, value,
                        self.output_dir / "best")


class EarlyStoppingCallback(Callback):
    """Stop after `patience` evals without `min_delta` improvement on the
    metric (parity with callbacks.py:221-270); trainer polls `should_stop`."""

    def __init__(self, patience: int = 5, min_delta: float = 0.001,
                 metric: str = "wer", greater_is_better: bool = False):
        self.patience = patience
        self.min_delta = min_delta
        self.metric = metric
        self.greater_is_better = greater_is_better
        self.best: float | None = None
        self.counter = 0
        self.should_stop = False

    def on_evaluate_end(self, trainer, metrics):
        value = metrics.get(self.metric)
        if value is None:
            return
        value = float(value)
        improved = (
            self.best is None
            or (value > self.best + self.min_delta if self.greater_is_better
                else value < self.best - self.min_delta))
        if improved:
            self.best = value
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
                logger.info("early stopping: no %s improvement in %d evals",
                            self.metric, self.patience)


class TensorBoardCallback(Callback):
    """Optional SummaryWriter mirror (parity with callbacks.py:273-310)."""

    def __init__(self, log_dir: str | Path, log_every: int = 50):
        self.log_dir = Path(log_dir)
        self.log_every = log_every
        self._writer = None

    def on_train_begin(self, trainer):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logger.warning("tensorboard unavailable; TensorBoardCallback no-op")
            return
        self._writer = SummaryWriter(str(self.log_dir))

    def on_step_end(self, trainer, step, logs):
        if self._writer and step % self.log_every == 0:
            for k, v in logs.items():
                self._writer.add_scalar(f"train/{k}", v, step)

    def on_evaluate_end(self, trainer, metrics):
        if self._writer:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._writer.add_scalar(f"eval/{k}", v, trainer.global_step)

    def on_train_end(self, trainer):
        if self._writer:
            self._writer.close()
