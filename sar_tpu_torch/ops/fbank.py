"""ESPnet's log-mel frontend, as OWSM runs it (espnet2's DefaultFrontend:
Stft + LogMel, then GlobalMVN; no counterpart in the JAX package, whose
models are all Whisper's).

    audio [B, 480000] --reflect pad 256--> 3001 centred frames (hop 160,
    n_fft 512, a periodic Hann window of 400 centred in the 512) @ windowed
    DFT basis (514 columns = cos/sin x 257 bins) --> |.|^2 --> Slaney mel
    filters (0-8000 Hz, librosa's htk=False) --> natural log of
    max(x, 1e-10) --> (x - mean) / std per bin (the model's stored
    statistics).

Computed in fp32 as two GEMMs, as ops/mel.py computes Whisper's: the STFT
on a strided view of the padded audio, never cuDNN's convolution (TF32 on
the card by default). Unlike Whisper's, every frame is kept (3001, not
3000) and there is no per-clip clamp. No kernel: the frontend is a small
share of a batch's device time.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from sar_tpu_torch.ops.mel import HOP_LENGTH, mel_filter_bank
from sar_tpu_torch.utils import profiling

N_FFT = 512
WIN_LENGTH = 400
N_FREQS = N_FFT // 2 + 1                      # 257


@functools.lru_cache(maxsize=2)
def _dft_kernels() -> np.ndarray:
    """Windowed DFT basis [N_FFT, 2 * N_FREQS] (shared cached array): the
    periodic Hann window of WIN_LENGTH zero-padded to N_FFT on both sides,
    as torch.stft pads a shorter window; columns cos then -sin."""
    n = np.arange(N_FFT, dtype=np.float64)
    win = np.zeros(N_FFT)
    left = (N_FFT - WIN_LENGTH) // 2
    w = np.arange(WIN_LENGTH, dtype=np.float64)
    win[left:left + WIN_LENGTH] = 0.5 * (1.0 - np.cos(2.0 * np.pi * w / WIN_LENGTH))
    phase = 2.0 * np.pi * np.outer(n, np.arange(N_FREQS)) / N_FFT
    return np.concatenate([win[:, None] * np.cos(phase), win[:, None] * -np.sin(phase)],
                          axis=1).astype(np.float32)


def fbank(audio: torch.Tensor, mvn: dict, num_mels: int = 80,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normalised log-mel features [B, num_mels, 3001] of 30 s windows
    audio [B, 480000] at 16 kHz, computed in fp32 on the audio's device and
    returned in `dtype`; `mvn` holds the per-bin "mean" and "std" [num_mels].
    A span (`fbank`) while a profiler is active."""
    with profiling.span("fbank"):
        return _fbank(audio, mvn, num_mels).to(dtype)


def _fbank(audio: torch.Tensor, mvn: dict, num_mels: int) -> torch.Tensor:
    if audio.dim() == 1:
        audio = audio[None]
    x = audio.float()
    dev = x.device
    half = N_FFT // 2
    x = F.pad(x[:, None, :], (half, half), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP_LENGTH)                     # [B, T, 512]
    out = torch.matmul(frames, torch.tensor(_dft_kernels(), device=dev))
    real, imag = out[..., :N_FREQS], out[..., N_FREQS:]
    power = real * real + imag * imag                            # [B, T, 257]
    fb = torch.tensor(mel_filter_bank(num_mels, N_FREQS), device=dev)
    logmel = torch.log(torch.clamp_min(torch.matmul(power, fb), 1e-10))
    feats = (logmel - mvn["mean"].float()) / mvn["std"].float()
    return feats.transpose(1, 2)                                  # [B, M, T]
