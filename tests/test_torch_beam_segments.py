"""`beam_decode(segment=s)` against sar_tpu's at the same `segment`, on the
CPU (whisper-test at fp32, the JAX weights bridged over and scaled x5 so
that beams diverge and depend on the input): tokens EXACTLY equal for
s in {0, 1, 5, 32} at K = 2 and 4 over the head-minor int8 cache (the
ancestry read; JAX's jnp path on the CPU), and over the int4 cache (the
physical reorder of the segment's rows) at K = 2. The greedy loop's
segments and its captured form: tests/test_torch_decode_graphs.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_port import get_config, jax_whisper, t

from sar_tpu.decode.beam import beam_decode as jax_beam
from sar_tpu.models import whisper as jw
from sar_tpu_torch.decode import beam_decode

CFG = get_config("whisper-test")
B = 3
PROMPT = CFG.prompt_ids("english")
NEW = 5
CACHES = {"int8_head_minor": dict(cross_kv_int8=True, self_kv_int8=True, head_minor=True),
          "int4": dict(cross_kv_int4=True, self_kv_int4=True)}


@pytest.fixture(scope="module")
def model():
    jp, tp = jax_whisper(CFG, seed=0, w_scale=5.0)
    mel = np.random.default_rng(7).standard_normal(
        (B, CFG.num_mel_bins, CFG.num_audio_frames)).astype(np.float32)
    return jp, tp, jw.encode(jp, jnp.asarray(mel), CFG)


@pytest.mark.parametrize("cache,K,segment", [
    *(("int8_head_minor", K, s) for K in (2, 4) for s in (0, 1, 5, 32)),
    ("int4", 2, 1), ("int4", 2, 5)])
def test_beam_tokens_equal_jax_per_segment(model, cache, K, segment):
    jp, tp, enc = model
    kw = CACHES[cache]
    # One program per case: outside jit, JAX compiles one loop per segment.
    want = jax.jit(functools.partial(jax_beam, cfg=CFG, num_beams=K, max_new_tokens=NEW,
                                     segment=segment, **kw))(
        jp, enc, prompt_ids=jnp.asarray(PROMPT, jnp.int32))
    got = beam_decode(tp, t(enc), CFG, PROMPT, num_beams=K, max_new_tokens=NEW,
                      segment=segment, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len({tuple(r) for r in got[:, len(PROMPT):].tolist()}) > 1   # the input matters
    jax.clear_caches()
