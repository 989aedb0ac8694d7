"""The frontend: how a config's 16 kHz audio becomes its encoder's features.

Every entry point of the port that starts from audio (the evaluator's
`from_audio`, the serving worker, long-form and streaming transcription,
the benchmark CLI and the s8 gate) calls `features`, so the decision
`cfg.frontend` names is made here once:

- "whisper": Whisper's log-mel (ops/mel.py);
- "espnet": ESPnet's log-mel normalised with the params' "mvn"
  statistics, as OWSM runs it (ops/fbank.py), of 30 s windows only.

Both keep the encoder's `cfg.num_audio_frames` frames. The batch reaches
the device as one copy of float32 samples and the frontend runs there in
fp32, returning `dtype`. `features` looks the two frontends up as module
attributes at each call, so a wrapper set on `mel_ops.log_mel_spectrogram`
or `fbank_ops.fbank` sees every call of every entry point.
"""

from __future__ import annotations

import numpy as np
import torch

from sar_tpu_torch.models.config import WhisperConfig
from sar_tpu_torch.ops import fbank as fbank_ops
from sar_tpu_torch.ops import mel as mel_ops


def window_samples(cfg: WhisperConfig) -> int:
    """Samples of one encoder window: 30 s for ESPnet's frontend, whose
    frames are centred on a 30 s clip; `num_audio_frames` hops for
    Whisper's."""
    if cfg.frontend == "espnet":
        return mel_ops.N_SAMPLES
    return cfg.num_audio_frames * mel_ops.HOP_LENGTH


def features(audio, cfg: WhisperConfig, params: dict | None, *,
             dtype: torch.dtype, device: torch.device | str,
             rows: int | None = None,
             samples: int = mel_ops.N_SAMPLES) -> torch.Tensor:
    """Encoder features [B, num_mel_bins, num_audio_frames] in `dtype` on
    `device` of `audio`: a list of 1-D clips (stacked on the host, with
    silent clips up to `rows`), a [B, N] host array or a tensor. Each clip
    is padded or trimmed to `samples`. An ESPnet config reads
    `params["mvn"]` and takes 30 s windows; a Whisper config reads no
    params."""
    espnet = cfg.frontend == "espnet"
    if espnet and samples != mel_ops.N_SAMPLES:
        raise ValueError(f"{cfg.name}: ESPnet's frontend takes 30 s windows "
                         f"({mel_ops.N_SAMPLES} samples), not {samples}")
    if espnet and "mvn" not in (params or {}):
        raise ValueError(f"{cfg.name}: ESPnet's frontend normalises with the "
                         f"checkpoint's MVN statistics, params['mvn'], which "
                         f"the params given do not hold")
    if isinstance(audio, (list, tuple)):
        silent = [np.zeros(0, np.float32)] * ((rows or 0) - len(audio))
        audio = mel_ops.stack_pad_audio(list(audio) + silent, samples)
    if not isinstance(audio, torch.Tensor):
        audio = torch.from_numpy(np.asarray(audio, np.float32))
    audio = mel_ops.pad_or_trim(audio.to(device, torch.float32), samples)
    if espnet:
        feats = fbank_ops.fbank(audio, params["mvn"], cfg.num_mel_bins, dtype=dtype)
    else:
        feats = mel_ops.log_mel_spectrogram(audio, cfg.num_mel_bins, dtype=dtype)
    return feats[:, :, :cfg.num_audio_frames]
