from sar_tpu_torch.evaluation.evaluator import ASREvaluator  # noqa: F401
