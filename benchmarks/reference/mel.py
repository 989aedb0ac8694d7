"""Plain log-mel features in float64: Whisper's frontend written out from
its definition (pad or trim to 30 s, centred STFT with a periodic Hann
window of 400 and hop 160 by `torch.fft.rfft`, power, Slaney mel filters,
log10 floored at 1e-10, the clip's dynamic range cut to 8, then
(x + 4) / 4). Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

SAMPLE_RATE = 16_000
N_FFT = 400
HOP = 160
N_SAMPLES = 30 * SAMPLE_RATE
N_FRAMES = N_SAMPLES // HOP


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = 3.0 * f / 200.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) * 27.0 / np.log(6.4), lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = 200.0 * m / 3.0
    return np.where(m >= 15.0, 1000.0 * np.exp((m - 15.0) * np.log(6.4) / 27.0), lin)


def mel_filters(n_mels: int) -> np.ndarray:
    """Slaney-normalised triangular filters [n_fft // 2 + 1, n_mels]."""
    freqs = np.fft.rfftfreq(N_FFT, 1.0 / SAMPLE_RATE)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    fb = np.zeros((freqs.size, n_mels))
    for m in range(n_mels):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        rise = (freqs - lo) / (mid - lo)
        fall = (hi - freqs) / (hi - mid)
        fb[:, m] = np.maximum(0.0, np.minimum(rise, fall)) * 2.0 / (hi - lo)
    return fb


def log_mel(audio, n_mels: int, device="cpu") -> torch.Tensor:
    """Clips (a list of 1-D arrays, 16 kHz) -> [B, n_mels, 3000] float64 on
    `device`."""
    x = np.zeros((len(audio), N_SAMPLES))
    for i, a in enumerate(audio):
        a = np.asarray(a, np.float64)[:N_SAMPLES]
        x[i, :a.size] = a
    x = torch.nn.functional.pad(torch.from_numpy(x).to(device)[:, None],
                                (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, N_FFT, HOP)[:, :N_FRAMES]
    window = torch.from_numpy(0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT)).to(device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = power @ torch.from_numpy(mel_filters(n_mels)).to(device)
    logm = torch.log10(torch.clamp_min(mel, 1e-10))
    logm = torch.maximum(logm, logm.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((logm + 4.0) / 4.0).transpose(1, 2)
