"""The port's beam search against sar_tpu on whisper-test at fp32 on the
CPU, the JAX weights bridged over (scaled x5 so that beams diverge and
depend on the input): `_self_attention_beam` and the beam-folded
`decode_step` logits within 1e-4, and `beam_decode` tokens EXACTLY equal
to JAX `beam_decode(head_minor=True, cross_kv_int8=True,
self_kv_int8=True)` for K in {2, 3, 4}, with suppress / begin-suppress,
a length penalty != 1, the no-EOS max-length case and LoRA banks; K=1
equals the port's greedy; the prompt is kept."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper, random_bank, t

from sar_tpu.decode.beam import beam_decode as jax_beam
from sar_tpu.models import whisper as jw
from sar_tpu_torch.decode import beam as tbeam
from sar_tpu_torch.decode import beam_decode, greedy_decode
from sar_tpu_torch.models import whisper as tw

CFG = get_config("whisper-test")
B = 3
H, hd = CFG.decoder_heads, CFG.d_model // CFG.decoder_heads
PROMPT = CFG.prompt_ids("english")
NEW = 12
INT8 = dict(cross_kv_int8=True, self_kv_int8=True)      # the int8 head-minor cache


@pytest.fixture(scope="module")
def model():
    jp, tp = jax_whisper(CFG, seed=0, w_scale=5.0)
    mel = np.random.default_rng(7).standard_normal(
        (B, CFG.num_mel_bins, CFG.num_audio_frames)).astype(np.float32)
    return jp, tp, jw.encode(jp, jnp.asarray(mel), CFG)


def _jax_tokens(jp, enc, K, **kw):
    return np.asarray(jax_beam(jp, enc, CFG, jnp.asarray(PROMPT, jnp.int32),
                               num_beams=K, cross_kv_int8=True, self_kv_int8=True,
                               head_minor=True, **kw))


def test_self_attention_beam_matches_jax():
    rng = np.random.default_rng(3)
    Bs, K, T, pos = 2, 3, 9, 6
    qh = rng.standard_normal((Bs * K, H, 1, hd)).astype(np.float32)
    kq, ks = jw.quantize_kv(jnp.asarray(rng.standard_normal((Bs * K, H, T, hd)), jnp.float32))
    vq, vs = jw.quantize_kv(jnp.asarray(rng.standard_normal((Bs * K, H, T, hd)), jnp.float32))
    anc = rng.integers(0, K, size=(Bs, K, T)).astype(np.int32)
    anc[:, :, pos] = np.arange(K)
    want = jw._self_attention_beam(jnp.asarray(qh), kq, vq, ks, vs,
                                   jnp.asarray(anc), pos, K)
    got = tw._self_attention_beam(t(qh), t(kq), t(vq), t(ks), t(vs),
                                  t(anc).long(), pos, K)
    assert got.shape == (Bs * K, H, 1, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_decode_step_beam_logits_match_jax(model):
    """Beam-folded steps with a random ancestry over a B*K self cache."""
    jp, tp, enc = model
    K, T = 3, 10
    jc = jw.init_cache(jp, enc, CFG, max_len=T, cross_kv_int8=True, self_kv_int8=True,
                       head_minor=True, self_batch=B * K)
    tc = tw.init_cache(tp, t(enc), CFG, max_len=T, self_batch=B * K, **INT8)
    assert tc.self_k.shape == (CFG.decoder_layers, B * K, H, T, hd)
    assert tc.cross_k.shape[1] == B
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
    np.testing.assert_array_equal(tc.self_k.numpy(), np.asarray(jc.self_k))


@pytest.mark.parametrize("K,kw", [
    (2, {}),
    (3, dict(length_penalty=0.6)),
    (4, dict(suppress_ids=(106, 92), begin_suppress_ids=(CFG.eos_token_id, 220))),
    (3, dict(suppress_ids=(CFG.eos_token_id,), max_new_tokens=40)),   # no EOS: max length
], ids=["K2", "K3-length-penalty", "K4-suppress", "K3-max-length"])
def test_beam_tokens_equal_jax(model, K, kw):
    jp, tp, enc = model
    kw = dict(kw)
    new = kw.pop("max_new_tokens", NEW)
    want = _jax_tokens(jp, enc, K, max_new_tokens=new, **kw)
    got = beam_decode(tp, t(enc), CFG, PROMPT, num_beams=K, max_new_tokens=new, **INT8, **kw)
    assert got.shape == (B, min(len(PROMPT) + new, CFG.max_target_positions))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("per_sample", [False, True], ids=["one-adapter", "per-sample"])
def test_beam_tokens_equal_jax_with_lora(model, per_sample):
    jp, tp, enc = model
    jb, tb = random_bank(CFG, 2 if per_sample else 1, 4, seed=9, std=0.3)
    idx = np.array([1, 0, 1]) if per_sample else None
    kw = dict(max_new_tokens=NEW, lora_scale=2.0)
    want = _jax_tokens(jp, enc, 3, lora=jb, adapter_idx=None if idx is None
                       else jnp.asarray(idx, jnp.int32), **kw)
    got = beam_decode(tp, t(enc), CFG, PROMPT, num_beams=3, lora=tb,
                      adapter_idx=None if idx is None else torch.from_numpy(idx), **INT8, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = beam_decode(tp, t(enc), CFG, PROMPT, num_beams=3, max_new_tokens=NEW, **INT8)
    assert not torch.equal(got, plain)          # the adapter moved the tokens


def test_one_beam_equals_greedy_and_the_prompt_is_kept(model):
    _, tp, enc = model
    greedy = greedy_decode(tp, t(enc), CFG, PROMPT, max_new_tokens=NEW, **INT8)
    np.testing.assert_array_equal(
        beam_decode(tp, t(enc), CFG, PROMPT, num_beams=1, max_new_tokens=NEW, **INT8).numpy(),
        greedy.numpy())
    prompts = torch.tensor([CFG.prompt_ids(lang) for lang in ("english", "german", "hindi")])
    out = beam_decode(tp, t(enc), CFG, prompts, num_beams=4, max_new_tokens=NEW, **INT8)
    assert torch.equal(out[:, :len(PROMPT)], prompts)
    assert not torch.equal(out, greedy)         # the beams found other sequences


def test_beam_select_alone_advances_the_state(model):
    """The selection after the logits, driven by hand as chip_smoke.py
    drives it: prompt steps leave the state as it is, the first generated
    step fills position P for every beam and composes the ancestry."""
    _, tp, enc = model
    K, total = 2, len(PROMPT) + 4
    prompt = torch.tensor(PROMPT)[None].expand(B, -1)
    state = tbeam.init_state(prompt, K, total, CFG.eos_token_id)
    cache = tw.init_cache(tp, t(enc), CFG, max_len=total, self_batch=B * K, **INT8)
    for pos in range(len(PROMPT)):
        state.anc[:, :, pos] = torch.arange(K)
        logits, cache = tw.decode_step(tp, state.run_seqs.reshape(B * K, total)[:, pos],
                                       pos, cache, CFG, beam_width=K, ancestry=state.anc)
        new = tbeam.beam_select(state, logits, pos, len(PROMPT), eos=CFG.eos_token_id)
        assert (new is state) == (pos + 1 < len(PROMPT))
        state = new
    P = len(PROMPT)
    assert (state.run_seqs[:, :, :P] == prompt[:, None]).all()
    assert (state.run_seqs[:, :, P] != CFG.eos_token_id).all()
    assert (state.run_scores < 0).all() and state.unsat.all()
    assert (state.anc[:, :, :P] < K).all()


def test_options_not_ported_raise(model):
    _, tp, enc = model
    # Beam timestamps are ported (tests/test_torch_decode_extras.py holds
    # their tokens to JAX's): they run.
    out = beam_decode(tp, t(enc), CFG, CFG.prompt_ids("english", no_timestamps=False),
                      num_beams=2, max_new_tokens=2, timestamps=True)
    assert out.shape == (B, len(PROMPT) + 1)
    # The classic int8 layout is ported (tests/test_torch_cache_layouts.py
    # holds its tokens to JAX's): it runs.
    out = beam_decode(tp, t(enc), CFG, PROMPT, num_beams=2, max_new_tokens=2,
                      head_minor=False, **INT8)
    assert out.shape == (B, len(PROMPT) + 2)
    with pytest.raises(ValueError):
        tw.decode_step(tp, torch.zeros(B, dtype=torch.long), 0,
                       tw.init_cache(tp, t(enc), CFG, 4, **INT8), CFG,
                       ancestry=torch.zeros((B, 1, 4), dtype=torch.long))
