"""The port's audio preprocessing against sar_tpu's on the CPU: `resample`
at 44.1k -> 16k, 8k -> 16k and 48k -> 16k on the native polyphase path
(native/resample.cpp, built by the port into build/) and on the numpy
convolution path, each against JAX's same path to 1e-5; `load_audio` on
WAV files the test writes (16-bit stereo at 44.1 kHz, 8-bit and 32-bit
mono), and a non-WAV file refused as JAX refuses it; AudioPreprocessor
(mono mix, resample, normalize, VAD trim, duration limits) and the seeded
SpecAugment against JAX's."""

import wave

import numpy as np
import pytest
import _torch_port  # noqa: F401  (one torch thread per worker)

from sar_tpu.data import preprocessing as jpp
from sar_tpu.utils import native as jnative
from sar_tpu_torch.data import preprocessing as tpp
from sar_tpu_torch.utils import native as tnative

# numpy's full convolution is slow at 44.1k (L=160, 28k taps): short input.
LENGTHS = {44100: 300, 8000: 4000, 48000: 9000}


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("orig_sr", [44100, 8000, 48000])
def test_resample_equals_jax(orig_sr, path, monkeypatch):
    from threadpoolctl import threadpool_limits
    if path == "numpy":
        monkeypatch.setattr(tnative, "resample_poly", lambda *a: None)
        monkeypatch.setattr(jnative, "resample_poly", lambda *a: None)
    else:
        assert tnative.native_available() and tnative.ACTIVE_PATH == "native"
    n = LENGTHS[orig_sr] if path == "numpy" else orig_sr // 5
    audio = np.random.default_rng(orig_sr).standard_normal(n).astype(np.float32)
    # np.convolve's long dot products go through BLAS, whose threads
    # contend with the other test workers' (minutes instead of a second):
    # one thread.
    with threadpool_limits(1):
        got = tpp.resample(audio, orig_sr, 16000)
        want = jpp.resample(audio, orig_sr, 16000)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_native_and_numpy_resample_agree(monkeypatch):
    audio = np.random.default_rng(1).standard_normal(2000).astype(np.float32)
    native = tpp.resample(audio, 8000, 16000)
    monkeypatch.setattr(tnative, "resample_poly", lambda *a: None)
    np.testing.assert_allclose(tpp.resample(audio, 8000, 16000), native, atol=1e-5, rtol=0)


def _write_wav(path, samples, sr, width, channels):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(samples.tobytes())


@pytest.mark.parametrize("kind", ["int16_stereo_44k", "uint8_mono_16k", "int32_mono_8k"])
def test_load_audio_equals_jax(kind, tmp_path):
    rng = np.random.default_rng(2)
    sr, width, ch, dtype = {"int16_stereo_44k": (44100, 2, 2, np.int16),
                            "uint8_mono_16k": (16000, 1, 1, np.uint8),
                            "int32_mono_8k": (8000, 4, 1, np.int32)}[kind]
    info = np.iinfo(dtype)
    n = sr // 20
    samples = rng.integers(info.min // 2, info.max // 2, size=n * ch).astype(dtype)
    path = tmp_path / f"{kind}.wav"
    _write_wav(path, samples, sr, width, ch)
    got = tpp.load_audio(path)
    want = jpp.load_audio(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_load_audio_refuses_other_formats_as_jax(tmp_path):
    path = tmp_path / "clip.flac"
    path.write_bytes(b"fLaC")
    errors = []
    for load in (tpp.load_audio, jpp.load_audio):
        with pytest.raises(Exception) as e:
            load(path)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("kw", [
    dict(), dict(trim_silence=True, trim_db=20.0),
    dict(normalize=False, max_duration=0.05, min_duration=None),
    dict(max_duration=None, min_duration=0.5, target_sr=8000)])
def test_audio_preprocessor_equals_jax(kw):
    rng = np.random.default_rng(4)
    audio = np.zeros((2, 9600), np.float32)
    audio[:, 3000:6000] = rng.standard_normal((2, 3000)) * 0.5
    audio += rng.standard_normal((2, 9600)).astype(np.float32) * 1e-3
    got = tpp.AudioPreprocessor(**kw)(audio, 48000)
    want = jpp.AudioPreprocessor(**kw)(audio, 48000)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_spec_augment_equals_jax():
    mel = np.random.default_rng(5).standard_normal((80, 300)).astype(np.float32)
    ours, theirs = tpp.SpecAugment(seed=3), jpp.SpecAugment(seed=3)
    for _ in range(3):
        np.testing.assert_array_equal(ours(mel), theirs(mel))
    assert not np.array_equal(ours(mel), mel)
