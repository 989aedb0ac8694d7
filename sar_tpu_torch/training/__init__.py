"""Training of the port: the LoRA trainer, the LID trainer, their
optimizer, checkpoints, callbacks, and the WER/CER metrics."""
from sar_tpu_torch.training.callbacks import (  # noqa: F401
    Callback,
    CheckpointCallback,
    EarlyStoppingCallback,
    TensorBoardCallback,
    WandbCallback,
)
from sar_tpu_torch.training.metrics import (  # noqa: F401
    analyze_errors,
    compute_cer,
    compute_metrics,
    compute_metrics_per_sample,
    compute_wer,
)
from sar_tpu_torch.training.lid_trainer import (  # noqa: F401
    LIDDataset,
    LIDTrainer,
    LIDTrainingArgs,
)
from sar_tpu_torch.training.trainer import ASRTrainer, TrainingArgs  # noqa: F401
