"""Model code of the port: configs, the Whisper model and the weight bridge."""

from sar_tpu_torch.models.config import (  # noqa: F401
    LANGUAGE_CODES,
    MODEL_CONFIGS,
    TARGET_LANGUAGES,
    WhisperConfig,
    get_config,
    get_model_info,
)
