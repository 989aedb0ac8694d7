"""Log-mel spectrogram frontend (counterpart of sar_tpu/ops/mel.py).

    audio [B, 480000] --reflect pad--> frames (hop 160, n_fft 400) @ windowed
    DFT basis (402 columns = cos/sin x 201 bins) --> |.|^2 --> mel filterbank
    GEMM --> log10 --> per-clip clamp at max - 8 --> (x + 4) / 4.

Numerics match HF's WhisperFeatureExtractor (periodic hann, n_fft=400,
hop=160, power 2, Slaney mel, log10, max-8 clamp, (x+4)/4), computed in
fp32 as two GEMMs. The STFT GEMM runs on a strided view of the padded audio
(`unfold`) and `torch.matmul`, never cuDNN's convolution, which would take
TF32 on the card by default. No kernel: the JAX package records why its
frontend has none (the DFT-as-GEMM formulation is a small share of the
end-to-end time), and the same holds here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from sar_tpu_torch.utils import profiling

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_SECONDS = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS       # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH            # 3000
N_FREQS = N_FFT // 2 + 1                      # 201


def hertz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney-scale hertz->mel (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    log_region = freq >= min_log_hertz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hertz) / min_log_hertz) * logstep,
        mels,
    )
    return mels


def mel_to_hertz(mels: np.ndarray) -> np.ndarray:
    """Inverse of :func:`hertz_to_mel`."""
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    log_region = mels >= min_log_mel
    freq = np.where(
        log_region,
        min_log_hertz * np.exp(logstep * (np.maximum(mels, min_log_mel) - min_log_mel)),
        freq,
    )
    return freq


@functools.lru_cache(maxsize=8)
def mel_filter_bank(num_mels: int = 80, num_freqs: int = N_FREQS,
                    sample_rate: int = SAMPLE_RATE,
                    fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Triangular Slaney-normalized mel filter bank, shape [num_freqs,
    num_mels] (shared cached array: callers copy before mutating)."""
    if fmax is None:
        fmax = sample_rate / 2.0
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, num_freqs)
    mel_pts = np.linspace(hertz_to_mel(fmin), hertz_to_mel(fmax), num_mels + 2)
    filter_freqs = mel_to_hertz(mel_pts)

    filter_diff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]          # [F, M+2]
    down = -slopes[:, :-2] / filter_diff[:-1]
    up = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))                   # [F, M]

    # Slaney energy normalization.
    enorm = 2.0 / (filter_freqs[2:num_mels + 2] - filter_freqs[:num_mels])
    fb = fb * enorm[None, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _dft_kernels(n_fft: int = N_FFT) -> np.ndarray:
    """Windowed DFT basis, shape [n_fft, 2 * n_freqs] (shared cached array).

    Column k       = hann(n) * cos(2*pi*k*n/n_fft)   (real part)
    Column F + k   = hann(n) * -sin(2*pi*k*n/n_fft)  (imag part)
    """
    n = np.arange(n_fft, dtype=np.float64)
    # Periodic hann window (np.hanning(N+1)[:-1]).
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    phase = 2.0 * np.pi * np.outer(n, k) / n_fft                 # [n_fft, F]
    real = window[:, None] * np.cos(phase)
    imag = window[:, None] * -np.sin(phase)
    return np.concatenate([real, imag], axis=1).astype(np.float32)


def pad_or_trim(audio: torch.Tensor, length: int = N_SAMPLES) -> torch.Tensor:
    """Zero-pad or truncate the last axis to `length` (the 30 s window)."""
    cur = audio.shape[-1]
    if cur >= length:
        return audio[..., :length]
    return F.pad(audio, (0, length - cur))


def stack_pad_audio(audios, length: int = N_SAMPLES) -> np.ndarray:
    """Host-side batch form of pad_or_trim: list of 1-D waveforms ->
    [B, length] float32."""
    out = np.zeros((len(audios), length), np.float32)
    for i, a in enumerate(audios):
        a = np.asarray(a, np.float32)[:length]
        out[i, :len(a)] = a
    return out


def log_mel_spectrogram(audio: torch.Tensor, num_mels: int = 80,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched log-mel features [B, num_mels, N_FRAMES] from audio
    [B, N_SAMPLES] (or [N_SAMPLES]) at 16 kHz, computed in fp32 on the
    audio's device and returned in `dtype`. A span (`mel`) while a
    profiler is active."""
    with profiling.span("mel"):
        return _log_mel(audio, num_mels).to(dtype)


def _log_mel(audio: torch.Tensor, num_mels: int) -> torch.Tensor:
    if audio.dim() == 1:
        audio = audio[None]
    x = audio.float()
    dev = x.device

    # center=True reflect padding of n_fft//2 on both sides.
    half = N_FFT // 2
    x = F.pad(x[:, None, :], (half, half), mode="reflect")[:, 0]

    # STFT as one GEMM: [B, T, n_fft] frames @ [n_fft, 2F] basis.
    kernels = torch.tensor(_dft_kernels(), device=dev)
    frames = x.unfold(-1, N_FFT, HOP_LENGTH)                      # [B, T, n_fft]
    out = torch.matmul(frames, kernels)[:, :N_FRAMES]             # drop HF's last frame
    real, imag = out[..., :N_FREQS], out[..., N_FREQS:]
    power = real * real + imag * imag                             # [B, T, F]

    fb = torch.tensor(mel_filter_bank(num_mels), device=dev)      # [F, M]
    mel = torch.matmul(power, fb).transpose(1, 2)                 # [B, M, T]

    log_spec = torch.log10(torch.clamp_min(mel, 1e-10))
    # Per-clip dynamic range clamp to (max - 8), then (x + 4) / 4.
    clip_max = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, clip_max - 8.0)
    return (log_spec + 4.0) / 4.0
