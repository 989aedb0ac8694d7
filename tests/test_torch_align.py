"""The port's word aligner against sar_tpu's on the CPU (whisper-test at
fp32, the JAX weights bridged over and scaled x5): the DTW path on the
native path (native/dtw.cpp, built by the port into build/) equal to the
numpy DP and to JAX's on random matrices and on matrices full of ties;
the median filter (reflect padding) and the alignment matrix to 1e-5;
the token-to-word split; and `align_words` (words, times, token spans
equal, probabilities to 1e-5) with the default heads and with explicit
ones and per-row frame counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_port import get_config, jax_whisper, t

from sar_tpu.decode import align as jalign
from sar_tpu.models import whisper as jw
from sar_tpu_torch.decode import align as talign
from sar_tpu_torch.decode import greedy_decode
from sar_tpu_torch.utils import native as tnative

CFG = get_config("whisper-test")
B = 2


class WordTok:
    """Every id a letter, every fifth a word start: words of a few tokens."""

    def decode(self, ids, skip_special_tokens=True):
        return "".join((" " if int(i) % 5 == 0 else "") + chr(97 + int(i) % 26)
                       for i in ids)


@pytest.fixture(scope="module")
def model():
    jp, tp = jax_whisper(CFG, seed=1, w_scale=5.0)
    mel = np.random.default_rng(5).standard_normal(
        (B, CFG.num_mel_bins, CFG.num_audio_frames)).astype(np.float32)
    enc = jw.encode(jp, jnp.asarray(mel), CFG)
    prompt = CFG.prompt_ids("english")
    tokens = greedy_decode(tp, t(enc), CFG, prompt, max_new_tokens=12)
    return jp, tp, mel, enc, tokens


@pytest.mark.parametrize("shape,ties", [((1, 1), False), ((1, 7), False), ((6, 1), False),
                                        ((9, 23), False), ((13, 13), True), ((20, 31), True)])
def test_dtw_paths_equal_native_numpy_and_jax(shape, ties):
    rng = np.random.default_rng(sum(shape))
    x = (rng.integers(-2, 3, size=shape) if ties else rng.standard_normal(shape))
    x = x.astype(np.float32)
    assert tnative.native_available()
    native = tnative.dtw(x)
    numpy_path = talign._dtw_numpy(x)
    jax_path = jalign.dtw_path(x)
    got = talign.dtw_path(x)
    for other in (numpy_path, jax_path, got):
        np.testing.assert_array_equal(native[0], other[0])
        np.testing.assert_array_equal(native[1], other[1])


@pytest.mark.parametrize("width,frames", [(1, 20), (3, 20), (7, 20), (7, 3), (7, 4), (4, 20)])
def test_median_filter_equals_jax(width, frames):
    x = np.random.default_rng(width + frames).standard_normal((2, 3, 5, frames))
    x = x.astype(np.float32)
    got = talign.median_filter(t(x), width).numpy()
    want = np.asarray(jalign.median_filter(jnp.asarray(x), width))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_alignment_matrix_equals_jax(model):
    jp, tp, _, enc, tokens = model
    heads = jalign.default_alignment_heads(CFG)
    assert talign.default_alignment_heads(CFG) == heads
    P = len(CFG.prompt_ids("english"))
    got = talign.alignment_matrix(tp, t(enc), tokens, CFG, heads, P)
    want = jalign.alignment_matrix(jp, enc, jnp.asarray(tokens.numpy(), jnp.int32), CFG,
                                   heads, P)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_split_words_equal_jax():
    ids = list(np.random.default_rng(3).integers(0, 120, size=40))
    assert talign.split_words(ids, WordTok()) == jalign.split_words(ids, WordTok())
    assert (talign.split_tokens_on_unicode(ids, WordTok())
            == jalign.split_tokens_on_unicode(ids, WordTok()))


@pytest.mark.parametrize("heads,frames", [(None, None), (((0, 1), (1, 2)), [20, 9])])
def test_align_words_equals_jax(model, heads, frames):
    jp, tp, mel, enc, tokens = model
    P = len(CFG.prompt_ids("english"))
    kw = dict(prompt_len=P, heads=heads, num_frames=frames, with_bounds=True)
    got, got_spans = talign.align_words(tp, t(mel), tokens, CFG, WordTok(), **kw)
    want, want_spans = jalign.align_words(jp, jnp.asarray(mel),
                                          jnp.asarray(tokens.numpy(), jnp.int32), CFG,
                                          WordTok(), **kw)
    assert got_spans == want_spans and sum(map(len, got)) > 2
    for row, wrow in zip(got, want):
        assert [(w["word"], w["start"], w["end"]) for w in row] == \
            [(w["word"], w["start"], w["end"]) for w in wrow]
        np.testing.assert_allclose([w["probability"] for w in row],
                                   [w["probability"] for w in wrow], atol=1e-5, rtol=0)
    jax.clear_caches()
