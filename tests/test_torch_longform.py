"""The port's long-form transcription against sar_tpu's on the CPU (after
tests/test_longform.py and tests/test_hallucination.py; whisper-test at
fp32, the JAX weights bridged over and scaled x5; its 30 s window is
0.64 s of audio, so chunk_seconds 0.6 cuts a 2.1 s clip into 4 windows):

- chunking with and without overlap and the overlapped-id merge equal to
  JAX's on random inputs;
- batched long-form against JAX's: fallback at T = 0, timestamps, words
  (the plain, overlapped and combined modes run through the CLI's test,
  tests/test_torch_transcribe_cli.py);
- the sequential conditioned loop against JAX's: conditioned on previous
  text, with words, and an initial prompt with timestamps (the seek; the
  carried prompt runs through the CLI's test);
- the seek, prompt-reset and hallucination rules with the decoder (and the
  aligner) stubbed by the same scripted fakes in both packages: text,
  segments, words and every prompt the fake was given equal."""

import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper

from sar_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
from sar_tpu.evaluation import fallback as jfb
from sar_tpu.evaluation import longform as jlf
from sar_tpu_torch.evaluation import fallback as tfb
from sar_tpu_torch.evaluation import longform as tlf

CFG = get_config("whisper-test")
NEW = 6


class LetterTok:
    """Every id a letter, every fifth a word start; encodes text to fixed
    ids (the initial prompt)."""

    def decode(self, ids, skip_special_tokens=True):
        return "".join((" " if int(i) % 5 == 0 else "") + chr(97 + int(i) % 26)
                       for i in ids)

    def encode(self, text, add_special_tokens=False):
        return [50, 51, 52]


@pytest.fixture(scope="module")
def model():
    jp, tp = jax_whisper(CFG, seed=0, w_scale=5.0)
    audio = (np.random.default_rng(11).standard_normal(int(2.1 * 16000)) * 0.3)
    return jp, tp, audio.astype(np.float32)


def test_chunking_and_merge_equal_jax():
    rng = np.random.default_rng(0)
    for n, chunk, overlap in ((500, 0.1, 0.0), (16000, 0.3, 0.05), (4000, 0.05, 0.02),
                              (3300, 0.1, 0.0)):
        audio = rng.standard_normal(n).astype(np.float32)
        got = tlf.chunk_audio_with_offsets(audio, chunk, overlap)
        want = jlf.chunk_audio_with_offsets(audio, chunk, overlap)
        assert [o for _, o in got] == [o for _, o in want]
        for (g, _), (w, _) in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert len(tlf.chunk_audio(audio, chunk, overlap)) == len(want)
    with pytest.raises(ValueError):
        tlf.chunk_audio(audio, 0.1, 0.1)
    for trial in range(10):
        seqs = [rng.integers(200, 210, size=rng.integers(0, 12)).tolist() for _ in range(4)]
        assert tlf.merge_overlapping_ids(seqs) == jlf.merge_overlapping_ids(seqs)


def _both(model, **kw):
    jp, tp, audio = model
    kw = dict(language="english", max_new_tokens=NEW, chunk_seconds=0.6, **kw)
    got = tlf.transcribe_long(audio, CFG, tp, JaxCharTokenizer(CFG), device="cpu", **kw)
    return got, jlf.transcribe_long(audio, CFG, jp, JaxCharTokenizer(CFG), **kw)


def _same(got, want):
    """Texts and segments equal; words equal but for the probability (1e-5)."""
    got, want = ((x,) if isinstance(x, str) else x for x in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g and isinstance(g, list) and isinstance(g[0], dict):
            assert [{**x, "probability": None} for x in g] == \
                [{**x, "probability": None} for x in w]
            np.testing.assert_allclose([x["probability"] for x in g],
                                       [x["probability"] for x in w], atol=1e-5)
        else:
            assert g == w


# The modes that tests/test_torch_transcribe_cli.py's long-form runs do
# not reach through the CLI (plain, overlapped, timestamps + words,
# conditioned with timestamps and the carried initial prompt run there).
BATCHED = {"fallback": dict(fallback=True, temperatures=(0.0,), no_speech_threshold=0.5),
           "timestamps": dict(timestamps=True), "words": dict(word_timestamps=True)}


@pytest.mark.parametrize("mode", list(BATCHED))
def test_batched_longform_equals_jax(model, mode):
    got, want = _both(model, batch_size=3, **BATCHED[mode])
    _same(got, want)
    if mode == "words":
        assert len(got[1]) > 2


CONDITIONED = {
    "previous_text": dict(condition_on_previous_text=True),
    "words": dict(condition_on_previous_text=True, word_timestamps=True),
    "initial_prompt": dict(initial_prompt="names", timestamps=True)}


@pytest.mark.parametrize("mode", list(CONDITIONED))
def test_conditioned_longform_equals_jax(model, mode):
    got, want = _both(model, **CONDITIONED[mode])
    _same(got, want)


class FakeTranscriber:
    """A scripted FallbackTranscriber: canned rows per window; records the
    prompts it was given."""
    script: list = []
    calls: list = []

    def __init__(self, cfg, params, tokenizer, **kw):
        pass

    def __call__(self, mel, n_valid=None, prompt=None, prompt_len=None):
        FakeTranscriber.calls.append(
            (None if prompt is None else np.asarray(prompt).tolist(), prompt_len))
        entry = FakeTranscriber.script[min(len(FakeTranscriber.calls),
                                           len(FakeTranscriber.script)) - 1]
        row = {"temperature": entry[2] if len(entry) > 2 else 0.0, "avg_logprob": -0.1,
               "no_speech_prob": 0.0, "compression_ratio": 1.0, "ids": list(entry[1])}
        return [entry[0]], [row]


class FakeAligner:
    """A scripted _window_segment_words: per call, one word list per split."""
    script: list = []
    calls = 0

    def __call__(self, params, feats, splits, cfg, tokenizer, *, align_prompt, lora,
                 lora_scale, chunk_len):
        out = FakeAligner.script[min(FakeAligner.calls, len(FakeAligner.script) - 1)]
        FakeAligner.calls += 1
        assert len(out) == len(splits)
        return out


def _ts(s):
    return CFG.no_timestamps_token_id + 1 + round(s / 0.02)


def _w(word, start, end, p):
    return {"word": word, "start": start, "end": end, "probability": p}


a, b, c, d, e, f = 60, 61, 62, 63, 64, 65
COND = dict(condition_on_previous_text=True, timestamps=True)
HAL = dict(COND, word_timestamps=True, hallucination_silence_threshold=1.0)
SCRIPTED = {
    "seek_closed_segment": (
        [("r0", [_ts(0.0), a, b, _ts(2.0), _ts(2.0), c, d]), ("r1", [_ts(0.0), e, _ts(1.0)]),
         ("r2", [f])], None, 5.0, dict(chunk_seconds=3.0, **COND)),
    "seek_floor": ([("t", [_ts(0.0), 60, _ts(0.5), _ts(0.5), 61])], None, 4.0,
                   dict(chunk_seconds=2.0, **COND)),
    "fixed_strides": ([("t", [_ts(0.0), 60, _ts(1.5), _ts(1.5), 61, _ts(2.0)])], None, 4.0,
                      dict(chunk_seconds=2.0, timestamp_seek=False, **COND)),
    "carry_through_reset": ([("w", [a], 1.0), ("w", [a]), ("w", [a])], None, 3.0,
                            dict(chunk_seconds=1.0, condition_on_previous_text=True,
                                 initial_prompt="names", carry_initial_prompt=True)),
    "reset_wipes_prompt": ([("w", [a], 1.0), ("w", [a]), ("w", [a])], None, 3.0,
                           dict(chunk_seconds=1.0, condition_on_previous_text=True,
                                initial_prompt="names")),
    "word_end_seek": (
        [("w0", [_ts(0.0), a, _ts(2.0), _ts(2.0), b]), ("w1", [_ts(0.0), e, _ts(1.0)])],
        [[[_w("aa", 0.3, 1.2, 0.9)]], [[_w("ee", 0.1, 0.8, 0.9)]], [[]]], 3.0,
        dict(chunk_seconds=2.0, word_timestamps=True, **COND)),
    "hallucination_gap": (
        [("h", [_ts(2.5), a, _ts(3.5)]), ("g", [_ts(0.0), e, _ts(1.0)])],
        [[[_w("xx", 2.6, 3.4, 0.01)]], [[_w("ee", 0.1, 0.9, 0.9)]], [[]]], 6.0,
        dict(chunk_seconds=4.0, **HAL)),
    "hallucination_surrounded": (
        [("w0", [_ts(0.2), a, _ts(1.0), _ts(3.0), b, _ts(4.0)]),
         ("w1", [_ts(0.0), e, _ts(1.0)])],
        [[[_w("aa", 0.3, 0.9, 0.9)], [_w("xx", 3.1, 3.9, 0.01)]],
         [[_w("ee", 0.1, 0.9, 0.9)]], [[]]], 8.0, dict(chunk_seconds=6.0, **HAL)),
}


@pytest.mark.parametrize("case", list(SCRIPTED))
def test_scripted_seek_reset_and_hallucination_rules_equal_jax(model, case, monkeypatch):
    _, tp, _ = model
    script, aligner, seconds, kw = SCRIPTED[case]
    audio = np.zeros(int(seconds * 16000), np.float32)
    outs = []
    for fb, lf, params, extra in ((tfb, tlf, tp, dict(device="cpu")), (jfb, jlf, None, {})):
        monkeypatch.setattr(fb, "FallbackTranscriber", FakeTranscriber)
        if aligner is not None:
            monkeypatch.setattr(lf, "_window_segment_words", FakeAligner())
        FakeTranscriber.script, FakeTranscriber.calls = script, []
        FakeAligner.script, FakeAligner.calls = aligner, 0
        out = lf.transcribe_long(audio, CFG, params, LetterTok(), language="english",
                                 max_new_tokens=8, **kw, **extra)
        outs.append((out, list(FakeTranscriber.calls)))
    assert outs[0] == outs[1]
    assert len(outs[0][1]) >= 2


def test_features_are_bf16_log_mel_of_the_padded_chunks():
    from sar_tpu.ops import mel as jmel
    chunks = [np.random.default_rng(1).standard_normal(n).astype(np.float32) * 0.1
              for n in (5000, 9000)]
    got = tlf.window_features(chunks, CFG, torch.device("cpu"), batch=3)
    assert got.dtype == torch.bfloat16 and got.shape == (3, CFG.num_mel_bins,
                                                         CFG.num_audio_frames)
    import jax.numpy as jnp
    want = jmel.log_mel_spectrogram(jnp.asarray(jmel.stack_pad_audio(
        chunks + [np.zeros(1, np.float32)])), CFG.num_mel_bins, dtype=jnp.float32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want)[:, :, :CFG.num_audio_frames],
                               atol=2 ** -6, rtol=2 ** -7)


def test_transcribe_long_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlf.transcribe_long(np.zeros(100, np.float32), CFG, {}, LetterTok())

