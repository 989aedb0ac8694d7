"""The port's slice end to end against sar_tpu on whisper-test with the JAX
weights bridged over (fp32 on the CPU): encode within 1e-4, the int8
head-minor cache within the K2 rules, decode_step logits within 1e-4 over
4 steps, greedy tokens exactly equal, and the evaluator's raw-audio path
equal to the JAX ASREvaluator prep/dec pair."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_whisper, t

from sar_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
from sar_tpu.decode.greedy import greedy_decode as jax_greedy
from sar_tpu.decode.greedy import transcribe_tokens as jax_transcribe_tokens
from sar_tpu.evaluation.evaluator import ASREvaluator as JaxEvaluator
from sar_tpu.models import whisper as jw
from sar_tpu.models.config import get_config
from sar_tpu.ops import mel as jmel
from sar_tpu_torch.data import CharTokenizer
from sar_tpu_torch.decode import greedy_decode, transcribe_tokens
from sar_tpu_torch.evaluation import ASREvaluator
from sar_tpu_torch.models import whisper as tw
from sar_tpu_torch.ops import mel as tmel

CFG = get_config("whisper-test")
B = 2
MAX_LEN = 16
INT8 = dict(cross_kv_int8=True, self_kv_int8=True)      # the int8 head-minor cache


@pytest.fixture(scope="module")
def model():
    jp, tp = jax_whisper(CFG, seed=0)
    mel = np.random.default_rng(7).standard_normal(
        (B, CFG.num_mel_bins, CFG.num_audio_frames)).astype(np.float32)
    enc_j = jw.encode(jp, jnp.asarray(mel), CFG)
    return jp, tp, mel, enc_j


@pytest.mark.parametrize("flash", [False, "hm"])
def test_encode_matches(model, flash):
    jp, tp, mel, enc_j = model
    got = tw.encode(tp, t(mel), CFG, flash=flash)
    assert got.shape == (B, CFG.max_source_positions, CFG.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(enc_j), atol=1e-4, rtol=0)


def test_init_cache_matches_the_k2_rules(model):
    jp, tp, _, enc_j = model
    want = jw.init_cache(jp, enc_j, CFG, max_len=MAX_LEN, cross_kv_int8=True,
                         self_kv_int8=True, head_minor=True)
    got = tw.init_cache(tp, t(enc_j), CFG, max_len=MAX_LEN, **INT8)
    for name in ("cross_k", "cross_v"):
        a = getattr(got, name).numpy().astype(np.int32)
        b = np.asarray(getattr(want, name)).astype(np.int32)
        assert a.shape == b.shape
        d = np.abs(a - b)
        assert d.max() <= 1 and (d != 0).mean() <= 1e-3
    for name in ("cross_k_scale", "cross_v_scale"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=1e-6, atol=0)
    for name in ("self_k", "self_v", "self_k_scale", "self_v_scale"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(a.shape) == b.shape and not a.any()
        assert str(a.dtype).split(".")[-1] == str(b.dtype)


def test_decode_step_logits_match_over_four_steps(model):
    jp, tp, _, enc_j = model
    jc = jw.init_cache(jp, enc_j, CFG, max_len=MAX_LEN, cross_kv_int8=True,
                       self_kv_int8=True, head_minor=True)
    tc = tw.init_cache(tp, t(enc_j), CFG, max_len=MAX_LEN, **INT8)
    toks = np.asarray([CFG.prompt_ids("english") + [7],
                       CFG.prompt_ids("german") + [200]])
    for pos in range(4):
        lj, jc = jw.decode_step(jp, jnp.asarray(toks[:, pos], jnp.int32),
                                jnp.int32(pos), jc, CFG)
        lt, tc = tw.decode_step(tp, torch.from_numpy(toks[:, pos]), pos, tc, CFG)
        assert lt.dtype == torch.float32 and lt.shape == (B, CFG.vocab_size)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tc.self_k.numpy(), np.asarray(jc.self_k))
    np.testing.assert_allclose(tc.self_v_scale.numpy(), np.asarray(jc.self_v_scale),
                               rtol=1e-6)


@pytest.mark.parametrize("suppress", [(), (106, 92)])
def test_greedy_tokens_equal_jax(model, suppress):
    jp, tp, _, enc_j = model
    prompt = CFG.prompt_ids("english")
    want = jax_greedy(jp, enc_j, CFG, jnp.asarray(prompt, jnp.int32),
                      max_new_tokens=12, cross_kv_int8=True, self_kv_int8=True,
                      head_minor=True, suppress_ids=suppress)
    got = greedy_decode(tp, t(enc_j), CFG, prompt, max_new_tokens=12,
                        suppress_ids=suppress, **INT8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (transcribe_tokens(got, CFG, len(prompt))
            == jax_transcribe_tokens(want, CFG, len(prompt)))


def test_greedy_stops_once_every_row_has_finished(monkeypatch):
    """EOS padding after finish and the early exit: with the final LN
    pinned to a constant row u and token_embed[eos] = 10u, every generated
    position picks EOS, and the loop stops after the first one."""
    _, tp = jax_whisper(CFG, seed=1)
    dec = tp["decoder"]
    dec["ln"] = {"scale": torch.zeros(CFG.d_model), "bias": torch.ones(CFG.d_model)}
    dec["token_embed"][CFG.eos_token_id] = 10.0
    calls = []
    real = tw.decode_step

    def counting(*a, **k):
        calls.append(a[2])
        return real(*a, **k)
    monkeypatch.setattr(tw, "decode_step", counting)
    enc = torch.zeros((B, CFG.max_source_positions, CFG.d_model))
    out = greedy_decode(tp, enc, CFG, CFG.prompt_ids("english"), max_new_tokens=10)
    P = len(CFG.prompt_ids("english"))
    assert out.shape == (B, P + 10)
    assert (out[:, P:] == CFG.eos_token_id).all()
    assert calls == list(range(P))                  # stopped after the first EOS


def test_evaluator_from_audio_matches_jax_prep_dec(model):
    jp, tp, _, _ = model
    rng = np.random.default_rng(9)
    clips = [rng.standard_normal(16000).astype(np.float32) * 0.1,
             rng.standard_normal(24000).astype(np.float32) * 0.3]
    jev = JaxEvaluator(CFG, jp, JaxCharTokenizer(CFG), language="english",
                       max_new_tokens=10)
    feats = jmel.log_mel_spectrogram(jnp.asarray(jmel.stack_pad_audio(clips)),
                                     CFG.num_mel_bins)[:, :, :CFG.num_audio_frames]
    tokens, _ = jev._decode(jp, jev._prep(jp, feats), jev._prompt)
    want = jax_transcribe_tokens(tokens, CFG, prompt_len=int(jev._prompt.shape[0]))

    ev = ASREvaluator(CFG, tp, language="english", max_new_tokens=10,
                      device="cpu")
    assert ev.flash is False and ev.device.type == "cpu"
    assert ev.from_audio(clips) == want
    texts = ASREvaluator(CFG, tp, CharTokenizer(CFG), language="english",
                         max_new_tokens=10, device="cpu").from_audio(np.stack(
                             [tmel.pad_or_trim(t(c)).numpy() for c in clips]))
    assert texts == [JaxCharTokenizer(CFG).decode(r) for r in want]


def test_evaluator_refuses_options_not_yet_ported(model):
    _, tp, _, _ = model
    for kw in (dict(kv_int8=False), dict(fallback=True)):
        with pytest.raises(NotImplementedError):
            ASREvaluator(CFG, tp, device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        tw.init_cache(tp, torch.zeros((1, 32, CFG.d_model)), CFG, 8, head_minor=False,
                      **INT8)


def test_bf16_slice_runs_and_keeps_logits_fp32(model):
    _, tp, mel, _ = model
    p16 = tw.cast_params(tp, torch.bfloat16)
    enc = tw.encode(p16, t(mel), CFG, flash="hm")
    assert enc.dtype == torch.bfloat16
    cache = tw.init_cache(p16, enc, CFG, max_len=MAX_LEN, **INT8)
    logits, _ = tw.decode_step(p16, torch.tensor([CFG.sot_token_id] * B), 0, cache, CFG)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    jax.clear_caches()
