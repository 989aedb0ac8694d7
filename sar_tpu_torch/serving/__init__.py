"""Serving of the port: the micro-batching TranscriptionService."""

from sar_tpu_torch.serving.service import TranscriptionService  # noqa: F401
