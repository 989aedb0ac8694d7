"""The port's streaming transcriber (sar_tpu_torch/evaluation/streaming.py)
on the CPU at whisper-test (window 0.64 s, 32 positions), the JAX weights
bridged over and scaled x3 so that hypotheses depend on the audio:

- the same chunks through JAX's StreamingTranscriber and the port's give
  the same committed ids after every feed, the same last hypothesis and
  the same finalize() text, over the default unquantized cache and over
  the int8 cache (JAX builds its classic int8 layout on the CPU, the port
  the head-minor one: the same quantization points; the ids are held
  equal, as the decode tests hold the int8 cache's); one JAX transcriber
  per cache for the module, reset between uses;
- tests/test_streaming.py's seven cases on the port: common_prefix_len,
  one full-window feed = the offline greedy decode, a forced prefix
  continued identically, no recapture across updates (JAX: no retrace),
  committed ids that never retract, finalize on an empty stream, feed
  after finalize, and the window rollover;
- `device` as the other entry points take it."""

import jax
import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper
from test_torch_decode_graphs import StandInSeam

from sar_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
from sar_tpu.evaluation.streaming import StreamingTranscriber as JaxStreaming
from sar_tpu.evaluation.streaming import common_prefix_len as jax_common_prefix_len
from sar_tpu_torch.data import CharTokenizer
from sar_tpu_torch.decode import greedy_decode, segments, transcribe_tokens
from sar_tpu_torch.evaluation.streaming import StreamingTranscriber, common_prefix_len
from sar_tpu_torch.models import whisper
from sar_tpu_torch.ops import mel as mel_ops

CFG = get_config("whisper-test")
CHUNKS = (0.4, 0.4, 0.4, 0.5)      # window fractions: the fourth feed rolls over


@pytest.fixture(scope="module")
def model():
    return jax_whisper(CFG, seed=0, w_scale=3.0)


@pytest.fixture(scope="module")
def jax_streams(model):
    """One JAX transcriber per cache (each compiles its own two jits)."""
    jp, _ = model
    return {kv: JaxStreaming(CFG, jp, JaxCharTokenizer(CFG), language="english",
                             kv_int8=kv) for kv in (False, True)}


def _stream(tp, **kw):
    return StreamingTranscriber(CFG, tp, CharTokenizer(CFG), language="english",
                                device="cpu", **kw)


def _chunks(n, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(f * n)) * 0.2).astype(np.float32) for f in CHUNKS]


@pytest.mark.parametrize("kv_int8", [False, True])
def test_feeds_equal_jax(model, jax_streams, kv_int8):
    _, tp = model
    want, got = jax_streams[kv_int8], _stream(tp, kv_int8=kv_int8)
    want.reset()
    assert got.window_samples == want.window_samples
    assert (got._p0, got._total, got._commit_cap) == (want._p0, want._total, want._commit_cap)
    committed = []
    for chunk in _chunks(got.window_samples):
        assert got.feed(chunk) == want.feed(chunk)
        assert got._committed == want._committed
        assert got._last_hyp == want._last_hyp and got._segments == want._segments
        committed.append(list(got._committed))
    assert got.hypothesis == want.hypothesis
    assert got.finalize() == want.finalize() and got._committed == want._committed
    # The audio matters, and the ids committed in a window grow past one.
    assert len(got._segments) == 1 and max(len(c) for c in committed) > 1
    jax.clear_caches()


def test_common_prefix_len():
    for a, b in (([1, 2, 3], [1, 2, 4]), ([], [1]), ([1, 2], [1, 2, 3]), ([5], [6])):
        assert common_prefix_len(a, b) == jax_common_prefix_len(a, b)
    assert common_prefix_len([1, 2, 3], [1, 2, 4]) == 2


def test_one_shot_matches_offline_greedy(model):
    """A single full-window feed reproduces the plain greedy decode (the
    forced-prefix path with an empty committed prefix IS the plain one)."""
    _, tp = model
    st = _stream(tp)
    audio = np.random.default_rng(5).standard_normal(st.window_samples).astype(np.float32)
    st.feed(audio)
    feats = mel_ops.log_mel_spectrogram(torch.from_numpy(audio[None]), CFG.num_mel_bins)
    enc = whisper.encode(tp, feats[:, :, :CFG.num_audio_frames], CFG)
    prompt = CFG.prompt_ids("english")
    tokens = greedy_decode(tp, enc, CFG, prompt, max_new_tokens=CFG.max_target_positions)
    assert st._last_hyp == transcribe_tokens(tokens, CFG, prompt_len=len(prompt))[0]


def test_forced_prefix_reproduces_continuation(model):
    """Greedy forced on a prefix of its own output continues identically:
    the invariant the committed transcript rides."""
    _, tp = model
    st = _stream(tp)
    st.feed(np.random.default_rng(6).standard_normal(st.window_samples // 2)
            .astype(np.float32))
    full = st._last_hyp
    assert len(full) > 2
    st._committed = full[:2]
    assert st._decode_window(st._audio) == full


def test_no_recapture_across_updates(model, monkeypatch):
    """Growing audio, a growing committed prefix and a rollover replay ONE
    program: each segment captured at most once, the static cache
    allocated once (JAX: one trace of each jit)."""
    _, tp = model
    st = _stream(tp)
    seams = []
    st.runner.capture = lambda: seams.append(StandInSeam()) or seams[-1]
    allocs = []
    real = whisper.empty_cache

    def counted(*a, **k):
        if str(k.get("device")) != "meta":     # init_cache's shape check
            allocs.append(1)
        return real(*a, **k)

    monkeypatch.setattr(whisper, "empty_cache", counted)
    for chunk in _chunks(st.window_samples, seed=7):
        st.feed(chunk)
    assert len(st._segments) == 1           # three feeds, then a rollover
    assert len(seams) == 1 and len(st.runner._programs) == 1 and len(allocs) == 1
    assert 1 <= seams[0].captured <= len(segments.grid(st._total, 32))
    prog = next(iter(st.runner._programs.values()))
    assert seams[0].captured == sum(r is not None for r in prog.replays)


def test_committed_text_is_monotonic(model):
    _, tp = model
    st = _stream(tp)
    rng = np.random.default_rng(8)
    prev: list[int] = []
    for _ in range(3):
        st.feed(rng.standard_normal(st.window_samples // 4).astype(np.float32))
        cur = list(st._committed)
        assert cur[:len(prev)] == prev     # never retracts committed ids
        prev = cur
    assert isinstance(st.finalize(), str)
    assert st._committed[:len(prev)] == prev


def test_finalize_without_audio_returns_empty(model):
    """finalize() on a fresh stream decodes nothing (real checkpoints
    hallucinate on silence)."""
    _, tp = model
    st = _stream(tp)
    assert st.finalize() == ""
    assert st._last_hyp is None


def test_feed_after_finalize_does_not_crash(model):
    """finalize() commits the whole hypothesis (it may pass the forced
    prefix's cap); a later feed caps it instead of overflowing the buffer."""
    _, tp = model
    st = _stream(tp)
    rng = np.random.default_rng(9)
    st.feed(rng.standard_normal(st.window_samples // 2).astype(np.float32))
    st.finalize()
    st._committed = list(range(st._total))  # worst case: an over-long commit
    st.feed(rng.standard_normal(st.window_samples // 4).astype(np.float32))
    assert isinstance(st.text, str) and len(st._committed) <= st._commit_cap


def test_window_rollover(model):
    _, tp = model
    st = _stream(tp)
    n = st.window_samples
    st.feed(np.random.default_rng(10).standard_normal(2 * n + n // 2).astype(np.float32))
    assert len(st._audio) <= n             # two windows rolled over
    assert len(st._segments) <= 2
    assert isinstance(st.finalize(), str)
    st.reset()
    assert st.text == ""


def test_the_transcriber_needs_a_device_without_cuda(model, monkeypatch):
    _, tp = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingTranscriber(CFG, tp, CharTokenizer(CFG))
    with pytest.raises(ValueError, match="CUDA"):
        _stream(tp, capture=True)
