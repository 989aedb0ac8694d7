"""Plain ESPnet log-mel features in float64, as OWSM's DefaultFrontend and
GlobalMVN compute them, written out from their definition: pad or trim to
30 s, `torch.stft` with n_fft 512, a periodic Hann window of 400, hop 160,
centred with reflect padding (3001 frames), power, Slaney mel filters over
0-8000 Hz (librosa's htk=False with its area normalisation), the natural
log floored at 1e-10, then (x - mean) / std per bin. Imports nothing of
the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.reference.mel import _hz_to_mel, _mel_to_hz

SAMPLE_RATE = 16_000
N_FFT = 512
WIN = 400
HOP = 160
N_SAMPLES = 30 * SAMPLE_RATE


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


def fbank(audio, mvn: dict, n_mels: int, device="cpu") -> torch.Tensor:
    """Clips (a list of 1-D arrays, 16 kHz) and the statistics `mvn`
    ("mean", "std" [n_mels]) -> [B, n_mels, 3001] float64 on `device`."""
    x = np.zeros((len(audio), N_SAMPLES))
    for i, a in enumerate(audio):
        a = np.asarray(a, np.float64)[:N_SAMPLES]
        x[i, :a.size] = a
    x = torch.from_numpy(x).to(device)
    window = torch.hann_window(WIN, periodic=True, dtype=torch.float64, device=device)
    spec = torch.stft(x, N_FFT, hop_length=HOP, win_length=WIN, window=window, center=True,
                      pad_mode="reflect", return_complex=True)      # [B, 257, 3001]
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.from_numpy(mel_filters(n_mels)).to(device)
    logm = torch.log(torch.clamp_min(torch.einsum("fm,bft->bmt", fb, power), 1e-10))
    mean = mvn["mean"].to(device, torch.float64)[:, None]
    std = mvn["std"].to(device, torch.float64)[:, None]
    return (logm - mean) / std
