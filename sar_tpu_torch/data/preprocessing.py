"""Audio preprocessing (counterpart of sar_tpu/data/preprocessing.py):
resample, normalize, energy-VAD trim, SpecAugment and `load_audio`.

Host code in numpy, as in the JAX package: AudioPreprocessor mixes to
mono, resamples to 16 kHz, peak-normalizes, optionally trims silence
(25 ms frames, 10 ms hop, threshold max_dB - trim_db) and truncates or
pads to the duration limits; SpecAugment (F=27, T=100, 2 + 2 masks) is
present and off by default; `load_audio` reads WAV through the stdlib
`wave` module. Resampling is rational polyphase with a Kaiser-windowed
sinc low-pass: the native kernel (native/resample.cpp through
utils/native.py) when a compiler is there, else the numpy convolution of
the same filter, with the same output length.
"""

from __future__ import annotations

import math
import wave
from pathlib import Path

import numpy as np


def _design_taps(L: int, M: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass at min(nyquist_in, nyquist_out), in the
    L-upsampled rate. One filter shared by the native and numpy paths."""
    cutoff = 0.5 / max(L, M)
    half = 32 * max(L, M)
    n = np.arange(-half, half + 1)
    return 2 * cutoff * np.sinc(2 * cutoff * n) * np.kaiser(2 * half + 1, 8.0)


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Rational-ratio resampling: zero-stuff L, Kaiser-sinc low-pass, take
    every M-th sample.

    The native polyphase kernel (native/resample.cpp) computes each output
    sample from only the ~n_taps/L overlapping taps; without it, the numpy
    path convolves the zero-stuffed signal in full (at 44.1 kHz -> 16 kHz,
    L=160 and M=441, ~1000x the multiplies), with the same filter and
    centring.
    """
    if orig_sr == target_sr:
        return audio.astype(np.float32)
    g = math.gcd(orig_sr, target_sr)
    L, M = target_sr // g, orig_sr // g
    taps = _design_taps(L, M)
    from sar_tpu_torch.utils.native import resample_poly
    out = resample_poly(audio, taps, L, M)
    if out is not None:
        return out
    up = np.zeros(len(audio) * L, np.float64)
    up[::L] = audio.astype(np.float64) * L
    # "full" + centered slice rather than mode="same": np.convolve("same")
    # returns max(len(up), len(taps)) samples, so for inputs shorter than
    # the filter it would DISAGREE with the native path in length; this
    # slice matches it for every input length.
    half = (len(taps) - 1) // 2
    full = np.convolve(up, taps, mode="full")
    return full[half:half + len(up):M].astype(np.float32)


class AudioPreprocessor:
    """Waveform conditioning before the mel frontend."""

    def __init__(self, target_sr: int = 16_000, normalize: bool = True,
                 trim_silence: bool = False, trim_db: float = 30.0,
                 max_duration: float | None = 30.0,
                 min_duration: float | None = None):
        self.target_sr = target_sr
        self.normalize = normalize
        self.trim_silence = trim_silence
        self.trim_db = trim_db
        self.max_duration = max_duration
        self.min_duration = min_duration

    def __call__(self, audio: np.ndarray, sr: int) -> np.ndarray:
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 2:                    # [channels, T] -> mono
            audio = audio.mean(axis=0)
        if sr != self.target_sr:
            audio = resample(audio, sr, self.target_sr)
        if self.normalize:
            peak = np.abs(audio).max()
            if peak > 0:
                audio = audio / peak
        if self.trim_silence:
            audio = self._trim(audio)
        if self.max_duration is not None:
            audio = audio[:int(self.max_duration * self.target_sr)]
        if self.min_duration is not None:
            need = int(self.min_duration * self.target_sr)
            if len(audio) < need:
                audio = np.pad(audio, (0, need - len(audio)))
        return audio

    def _trim(self, audio: np.ndarray) -> np.ndarray:
        """Energy VAD: drop leading/trailing frames quieter than
        (max_dB - trim_db); 25 ms frames, 10 ms hop."""
        frame = int(0.025 * self.target_sr)
        hop = int(0.010 * self.target_sr)
        if len(audio) < frame:
            return audio
        n = 1 + (len(audio) - frame) // hop
        starts = np.arange(n) * hop
        frames = np.stack([audio[s:s + frame] for s in starts])
        db = 10 * np.log10(np.mean(frames ** 2, axis=1) + 1e-10)
        keep = db > db.max() - self.trim_db
        if not keep.any():
            return audio
        first, last = np.argmax(keep), len(keep) - 1 - np.argmax(keep[::-1])
        return audio[starts[first]:starts[last] + frame]


class SpecAugment:
    """Frequency/time masking on mel features [M, T] (defaults F=27, T=100,
    2 frequency + 2 time masks). Disabled by default in the pipeline."""

    def __init__(self, freq_mask_param: int = 27, time_mask_param: int = 100,
                 n_freq_masks: int = 2, n_time_masks: int = 2,
                 seed: int | None = None):
        self.F = freq_mask_param
        self.T = time_mask_param
        self.nF = n_freq_masks
        self.nT = n_time_masks
        self._rng = np.random.default_rng(seed)

    def __call__(self, mel: np.ndarray) -> np.ndarray:
        mel = np.array(mel, copy=True)
        M, T = mel.shape[-2], mel.shape[-1]
        fill = mel.mean()
        for _ in range(self.nF):
            f = int(self._rng.integers(0, self.F + 1))
            if f and f < M:
                f0 = int(self._rng.integers(0, M - f))
                mel[..., f0:f0 + f, :] = fill
        for _ in range(self.nT):
            t = int(self._rng.integers(0, self.T + 1))
            if t and t < T:
                t0 = int(self._rng.integers(0, T - t))
                mel[..., :, t0:t0 + t] = fill
        return mel


def load_audio(path: str | Path, target_sr: int = 16_000) -> np.ndarray:
    """Load an audio file -> mono float32 at target_sr. WAV via stdlib;
    other formats via soundfile when available."""
    path = Path(path)
    if path.suffix.lower() == ".wav":
        with wave.open(str(path), "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            width = w.getsampwidth()
            raw = w.readframes(n)
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
        audio = np.frombuffer(raw, dtype=dtype).astype(np.float32)
        if width == 1:
            audio = (audio - 128.0) / 128.0
        else:
            audio = audio / float(np.iinfo(dtype).max)
        if w.getnchannels() > 1:
            audio = audio.reshape(-1, w.getnchannels()).mean(axis=1)
    else:
        try:
            import soundfile as sf
        except ImportError as e:
            raise RuntimeError(
                f"Cannot read {path.suffix} without soundfile installed") from e
        audio, sr = sf.read(path, dtype="float32")
        if audio.ndim == 2:
            audio = audio.mean(axis=1)
    return AudioPreprocessor(target_sr=target_sr, normalize=False,
                             max_duration=None)(audio, sr)
