"""The decode functions' defaults equal the JAX package's: with no cache
flags, `init_cache`, `greedy_decode` and `beam_decode` build and read the
unquantized classic cache, as JAX's do. On whisper-test at fp32 on the CPU
with the JAX weights bridged over (scaled x5 so that beams diverge and
depend on the input): `_self_attention_beam` without scales and the
beam-folded `decode_step` over the classic cache within 1e-4 of JAX's
(fp32 sums in another order), greedy and beam tokens (K = 2 and 4) EXACTLY
equal to JAX's with their defaults, without a bank, with one adapter and
with per-row adapters, and `WhisperLoRA.generate` equal to JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_whisper, random_bank, t

from sar_tpu.decode.beam import beam_decode as jax_beam
from sar_tpu.decode.greedy import greedy_decode as jax_greedy
from sar_tpu.models import lora as jlora
from sar_tpu.models import whisper as jw
from sar_tpu.models.config import get_config
from sar_tpu.models.whisper_lora import WhisperLoRA as JaxWhisperLoRA
from sar_tpu_torch.decode import beam_decode, greedy_decode
from sar_tpu_torch.models import lora as tlora
from sar_tpu_torch.models import whisper as tw
from sar_tpu_torch.models.whisper_lora import WhisperLoRA

CFG = get_config("whisper-test")
B = 3
H, hd = CFG.decoder_heads, CFG.d_model // CFG.decoder_heads
PROMPT = CFG.prompt_ids("english")
NEW = 12


@pytest.fixture(scope="module")
def model():
    jp, tp = jax_whisper(CFG, seed=0, w_scale=5.0)
    mel = np.random.default_rng(7).standard_normal(
        (B, CFG.num_mel_bins, CFG.num_audio_frames)).astype(np.float32)
    return jp, tp, mel, jw.encode(jp, jnp.asarray(mel), CFG)


def test_default_cache_is_the_classic_unquantized_one(model):
    jp, tp, _, enc = model
    want = jw.init_cache(jp, enc, CFG, max_len=10, self_batch=2 * B)
    got = tw.init_cache(tp, t(enc), CFG, max_len=10, self_batch=2 * B)
    for name, a in got._asdict().items():
        b = getattr(want, name)
        if a is None:
            assert b is None, name
            continue
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_self_attention_beam_without_scales_matches_jax():
    rng = np.random.default_rng(4)
    Bs, K, T, pos = 2, 3, 9, 6
    qh, sk, sv = (rng.standard_normal(s).astype(np.float32)
                  for s in ((Bs * K, H, 1, hd), (Bs * K, H, T, hd), (Bs * K, H, T, hd)))
    anc = rng.integers(0, K, size=(Bs, K, T)).astype(np.int32)
    anc[:, :, pos] = np.arange(K)
    want = jw._self_attention_beam(jnp.asarray(qh), jnp.asarray(sk), jnp.asarray(sv),
                                   None, None, jnp.asarray(anc), pos, K)
    got = tw._self_attention_beam(t(qh), t(sk), t(sv), None, None, t(anc).long(), pos, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_decode_step_beam_over_the_classic_cache_matches_jax(model):
    jp, tp, _, enc = model
    K, T = 2, 10
    jc = jw.init_cache(jp, enc, CFG, max_len=T, self_batch=B * K)
    tc = tw.init_cache(tp, t(enc), CFG, max_len=T, self_batch=B * K)
    rng = np.random.default_rng(5)
    anc = rng.integers(0, K, size=(B, K, T)).astype(np.int32)
    for pos in range(5):
        anc[:, :, pos] = np.arange(K)
        toks = rng.integers(0, CFG.vocab_size, size=B * K)
        lj, jc = jw.decode_step(jp, jnp.asarray(toks, jnp.int32), jnp.int32(pos), jc, CFG,
                                beam_width=K, ancestry=jnp.asarray(anc))
        lt, tc = tw.decode_step(tp, torch.from_numpy(toks), pos, tc, CFG,
                                beam_width=K, ancestry=t(anc).long())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
        anc = anc[np.arange(B)[:, None], rng.integers(0, K, size=(B, K))]
    np.testing.assert_allclose(tc.self_k.numpy(), np.asarray(jc.self_k), atol=1e-5)


def _bank(mode):
    """(JAX kwargs, port kwargs) of a decode without a bank, with one
    adapter, or with per-row adapters."""
    if mode == "no-bank":
        return {}, {}
    jb, tb = random_bank(CFG, 2, 4, seed=9, std=0.3)
    if mode == "one-adapter":
        return dict(lora=jb, lora_scale=2.0), dict(lora=tb, lora_scale=2.0)
    idx = np.array([1, 0, 1], np.int32)
    return (dict(lora=jb, lora_scale=2.0, adapter_idx=jnp.asarray(idx)),
            dict(lora=tb, lora_scale=2.0, adapter_idx=torch.from_numpy(idx)))


MODES = ["no-bank", "one-adapter", "per-row"]


@pytest.mark.parametrize("mode", MODES)
def test_greedy_tokens_with_the_defaults_equal_jax(model, mode):
    jp, tp, _, enc = model
    jkw, tkw = _bank(mode)
    want = jax_greedy(jp, enc, CFG, jnp.asarray(PROMPT, jnp.int32), max_new_tokens=NEW, **jkw)
    got = greedy_decode(tp, t(enc), CFG, PROMPT, max_new_tokens=NEW, **tkw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("K,mode", [(2, "no-bank"), (2, "per-row"), (4, "no-bank"),
                                    (4, "one-adapter")])
def test_beam_tokens_with_the_defaults_equal_jax(model, K, mode):
    jp, tp, _, enc = model
    jkw, tkw = _bank(mode)
    want = jax_beam(jp, enc, CFG, jnp.asarray(PROMPT, jnp.int32), num_beams=K,
                    max_new_tokens=NEW, **jkw)
    got = beam_decode(tp, t(enc), CFG, PROMPT, num_beams=K, max_new_tokens=NEW, **tkw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if K == 4 and mode == "no-bank":
        assert not torch.equal(got, greedy_decode(tp, t(enc), CFG, PROMPT,
                                                  max_new_tokens=NEW))


@pytest.mark.parametrize("num_beams", [1, 2])
def test_whisper_lora_generate_equals_jax(model, num_beams):
    jp, tp, mel, _ = model
    jb, tb = random_bank(CFG, 1, 4, seed=3, std=0.3)
    jm = JaxWhisperLoRA(CFG, jp, jb, jlora.LoraConfig(r=4, alpha=8), language="english")
    tm = WhisperLoRA(CFG, tp, tb, tlora.LoraConfig(r=4, alpha=8), language="english",
                     device="cpu")
    want = jm.generate(jnp.asarray(mel), max_new_tokens=NEW, num_beams=num_beams)
    got = tm.generate(t(mel), max_new_tokens=NEW, num_beams=num_beams)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
