"""The decode extras of the port against sar_tpu on the CPU (whisper-test at
fp32, the JAX weights bridged over and scaled x5 so that tokens depend on
the input; its timestamp tokens are ids 107..255, so random weights emit
many):

- `apply_timestamp_rules` equal to JAX's and to HF's
  WhisperTimeStampLogitsProcessor on crafted prefixes and on a random
  walk, with the prompt length as an int and as a 0-d tensor;
- greedy with the options (timestamps, logprobs, no-speech,
  begin_suppress_ids, a per-call prompt_len under a wider buffer with
  no_speech_pos and max_gen_tokens): tokens equal to JAX's, the logprob
  sums to 1e-4 relative, the counts equal, no-speech to 1e-5;
- sampling: T = 0 equal to plain greedy, the step sampler equal to JAX's
  formula on shared uniforms, the draws seeded;
- beam search with timestamps equal to JAX's (which tests/test_timestamps.py
  holds to HF's generate);
- `detect_language` and `decode_cross_attn` to 1e-5;
- the DecodeRunner with the options through the stand-in capture seam:
  one key serves every prompt length, temperature and seed, and each call
  equals a fresh module-function call; an option turned on is a new key."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper, t

from sar_tpu.decode.beam import beam_decode as jax_beam
from sar_tpu.decode.greedy import greedy_decode as jax_greedy
from sar_tpu.decode.greedy import greedy_decode_from_cache as jax_greedy_cache
from sar_tpu.decode.timestamps import apply_timestamp_rules as jax_rules
from sar_tpu.models import whisper as jw
from sar_tpu_torch.decode import beam_decode, graphs, greedy_decode
from sar_tpu_torch.decode.greedy import (greedy_decode_from_cache, gumbel_argmax,
                                         step_uniforms)
from sar_tpu_torch.decode.timestamps import apply_timestamp_rules
from sar_tpu_torch.models import whisper as tw

CFG = get_config("whisper-test")
B = 3
NEW = 12
TS_PROMPT = CFG.prompt_ids("english", no_timestamps=False)


@pytest.fixture(scope="module")
def model():
    jp, tp = jax_whisper(CFG, seed=0, w_scale=5.0)
    mel = np.random.default_rng(7).standard_normal(
        (B, CFG.num_mel_bins, CFG.num_audio_frames)).astype(np.float32)
    return jp, tp, jw.encode(jp, jnp.asarray(mel), CFG)


def _hf_processor(cfg, begin_index):
    from transformers import GenerationConfig
    from transformers.generation.logits_process import WhisperTimeStampLogitsProcessor
    gen_cfg = GenerationConfig(eos_token_id=cfg.eos_token_id)
    gen_cfg.no_timestamps_token_id = cfg.no_timestamps_token_id
    gen_cfg.max_initial_timestamp_index = 1
    return WhisperTimeStampLogitsProcessor(gen_cfg, begin_index=begin_index)


def _ours_and_jax(cfg, scores, seq, total, pos, P, plen_tensor):
    buf = np.full((len(seq), total), cfg.eos_token_id, np.int64)
    for b, s in enumerate(seq):
        buf[b, :len(s)] = s
    plen = torch.tensor(P) if plen_tensor else P
    ours = apply_timestamp_rules(torch.from_numpy(scores.copy()), torch.from_numpy(buf),
                                 pos, plen, cfg, max_initial_timestamp_index=1).numpy()
    want = np.asarray(jax_rules(jnp.asarray(scores), jnp.asarray(buf, jnp.int32),
                                jnp.int32(pos), jnp.int32(P), cfg,
                                max_initial_timestamp_index=1))
    return ours, want


def _same_masks(ours, want, theirs, what):
    for other in (want, theirs):
        np.testing.assert_array_equal(np.isneginf(ours), np.isneginf(other), err_msg=what)
        finite = ~np.isneginf(other)
        np.testing.assert_allclose(ours[finite], other[finite], rtol=1e-6, err_msg=what)


PREFIXES = [[4, 9], [4, 9, "t1"], [4, 9, "t1", 17], [4, 9, "t1", "t1"],
            [4, 9, "t2", 17, "t4", "t6"]]


@pytest.mark.parametrize("plen_tensor", [False, True])
@pytest.mark.parametrize("prefix", range(len(PREFIXES)))
def test_timestamp_rules_equal_jax_and_hf_on_crafted_prefixes(prefix, plen_tensor):
    """Each grammar branch: the initial position, a lone timestamp, text
    after an opening one, a completed pair, rising stamps."""
    cfg = CFG
    ts = cfg.no_timestamps_token_id + 1
    seq = [ts + int(x[1]) if isinstance(x, str) else x for x in PREFIXES[prefix]]
    scores = np.random.default_rng(prefix).standard_normal((1, 256)).astype(np.float32) * 3
    theirs = _hf_processor(cfg, 2)(torch.tensor([seq]), torch.from_numpy(scores.copy())).numpy()
    ours, want = _ours_and_jax(cfg, scores, [seq], 12, len(seq) - 1, 2, plen_tensor)
    _same_masks(ours, want, theirs, f"prefix {seq}")


def test_timestamp_rules_equal_jax_and_hf_on_a_walk():
    cfg = CFG
    rng = np.random.default_rng(0)
    P, seqs = len(TS_PROMPT), [list(TS_PROMPT) for _ in range(3)]
    proc = _hf_processor(cfg, P)
    for step in range(10):
        scores = rng.standard_normal((3, 256)).astype(np.float32) * 3
        theirs = proc(torch.tensor(seqs), torch.from_numpy(scores.copy())).numpy()
        ours, want = _ours_and_jax(cfg, scores, seqs, 16, P - 1 + step, P, step % 2 == 1)
        _same_masks(ours, want, theirs, f"step {step}")
        for b, n in enumerate(theirs.argmax(-1)):
            seqs[b].append(int(n))


def _check_outputs(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if len(want) > 2:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if len(want) in (2, 4):
        np.testing.assert_allclose(got[-1].numpy(), np.asarray(want[-1]), rtol=0, atol=1e-5)


def test_greedy_timestamps_logprobs_no_speech_equal_jax(model):
    jp, tp, enc = model
    prompt = CFG.prompt_ids("english", no_timestamps=False)
    kw = dict(timestamps=True, with_logprobs=True, with_no_speech=True)
    want = jax.jit(functools.partial(jax_greedy, cfg=CFG, max_new_tokens=NEW, **kw))(
        jp, enc, prompt_ids=jnp.asarray(prompt, jnp.int32), rng=jax.random.PRNGKey(0),
        temperature=0.0)
    got = greedy_decode(tp, t(enc), CFG, prompt, max_new_tokens=NEW, seed=0, **kw)
    _check_outputs(got, want)
    ts = CFG.no_timestamps_token_id + 1
    assert (got[0][:, len(prompt):] >= ts).any() and (got[0][:, len(prompt):] < ts).any()
    assert len({tuple(r) for r in got[0].tolist()}) > 1
    jax.clear_caches()


def test_greedy_begin_suppress_equal_jax(model):
    jp, tp, enc = model
    prompt = CFG.prompt_ids("english")
    begin = (CFG.eos_token_id, 15, 35)      # 15: every row's first token otherwise
    want = jax.jit(functools.partial(jax_greedy, cfg=CFG, max_new_tokens=NEW,
                                     begin_suppress_ids=begin, with_logprobs=True))(
        jp, enc, prompt_ids=jnp.asarray(prompt, jnp.int32))
    got = greedy_decode(tp, t(enc), CFG, prompt, max_new_tokens=NEW,
                        begin_suppress_ids=begin, with_logprobs=True)
    _check_outputs(got, want)
    plain = greedy_decode(tp, t(enc), CFG, prompt, max_new_tokens=NEW)
    assert not torch.equal(plain, got[0])            # the mask moved the first token
    jax.clear_caches()


def test_greedy_dynamic_prompt_len_no_speech_pos_and_cap_equal_jax(model):
    """A conditioned prompt (<|startofprev|> + context + the standard
    prompt) in a wider buffer: the forced length, the <|sot|> position
    of the no-speech read and the generation cap are per-call values."""
    jp, tp, enc = model
    std = CFG.prompt_ids("english")
    ids = [CFG.prev_sot_token_id, 130, 131, 140] + std
    width, cap = len(ids) + 5, 6
    buf = np.full((B, width), CFG.eos_token_id, np.int64)
    buf[:, :len(ids)] = ids
    total = width + 8
    kw = dict(with_logprobs=True, with_no_speech=True, segment=4)
    jcache = jw.init_cache(jp, enc, CFG, max_len=total)
    want = jax.jit(functools.partial(jax_greedy_cache, cfg=CFG, max_gen_tokens=cap,
                                     **kw))(
        jp, jcache, prompt_ids=jnp.asarray(buf, jnp.int32), prompt_len=jnp.int32(len(ids)),
        no_speech_pos=jnp.int32(len(ids) - len(std)), rng=jax.random.PRNGKey(1),
        temperature=0.0)
    cache = tw.init_cache(tp, t(enc), CFG, total)
    got = greedy_decode_from_cache(tp, cache, CFG, buf, prompt_len=len(ids), seed=1,
                                   no_speech_pos=len(ids) - len(std), max_gen_tokens=cap,
                                   **kw)
    _check_outputs(got, want)
    assert int(got[2].max()) == cap
    assert (got[0][:, len(ids) + cap:] == CFG.eos_token_id).all()
    jax.clear_caches()


def test_sampling_at_zero_temperature_is_greedy_and_seeded(model):
    _, tp, enc = model
    prompt = CFG.prompt_ids("english")
    plain = greedy_decode(tp, t(enc), CFG, prompt, max_new_tokens=NEW)
    for seed in (0, 9):
        got = greedy_decode(tp, t(enc), CFG, prompt, max_new_tokens=NEW, seed=seed,
                            temperature=0.0)
        assert torch.equal(got, plain)
    a, b, c = (greedy_decode(tp, t(enc), CFG, prompt, max_new_tokens=NEW, seed=s,
                             temperature=1.0) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="seed"):
        greedy_decode(tp, t(enc), CFG, prompt, max_new_tokens=NEW, temperature=0.5)


@pytest.mark.parametrize("temperature", [0.0, 0.3, 1.0])
def test_step_sampler_equals_jax_formula(temperature):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((4, 300)) * 2).astype(np.float32)
    logits[:, 7] = np.finfo(np.float32).min            # a suppressed entry
    logits[1, 9] = -np.inf                             # a grammar mask
    u = step_uniforms(torch.tensor(5), 11, 4, 300)
    assert u.dtype == torch.float32 and bool((u > 0).all() and (u < 1).all())
    assert not torch.equal(u, step_uniforms(torch.tensor(5), 12, 4, 300))
    assert not torch.equal(u, step_uniforms(torch.tensor(6), 11, 4, 300))
    got = gumbel_argmax(torch.from_numpy(logits), u, torch.tensor(temperature))
    ju = jnp.asarray(u.numpy())
    want = jnp.argmax(jnp.asarray(logits) + jnp.float32(temperature) * -jnp.log(-jnp.log(ju)),
                      -1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if temperature == 0.0:
        np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


def test_beam_timestamps_equal_jax(model):
    jp, tp, enc = model
    want = jax.jit(functools.partial(jax_beam, cfg=CFG, num_beams=2, max_new_tokens=10,
                                     timestamps=True, segment=4))(
        jp, enc, prompt_ids=jnp.asarray(TS_PROMPT, jnp.int32))
    got = beam_decode(tp, t(enc), CFG, TS_PROMPT, num_beams=2, max_new_tokens=10,
                      timestamps=True, segment=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gen = got[:, len(TS_PROMPT):]
    assert (gen > CFG.no_timestamps_token_id).any() and (gen < CFG.eos_token_id + 100).any()
    jax.clear_caches()


def test_detect_language_and_decode_cross_attn_equal_jax(model):
    jp, tp, enc = model
    idx, probs = tw.detect_language(tp, t(enc), CFG)
    jidx, jprobs = jw.detect_language(jp, enc, CFG)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-5, rtol=0)
    prompt = CFG.prompt_ids("english")
    tokens = greedy_decode(tp, t(enc), CFG, prompt, max_new_tokens=NEW)
    heads = ((1, 0), (1, 3), (0, 2))
    maps, tprobs = tw.decode_cross_attn(tp, t(enc), tokens, CFG, heads=heads,
                                        with_token_probs=True)
    jmaps, jtprobs = jax.jit(functools.partial(jw.decode_cross_attn, cfg=CFG, heads=heads,
                                               with_token_probs=True))(
        jp, enc, jnp.asarray(tokens.numpy(), jnp.int32))
    assert maps.shape == (B, 3, tokens.shape[1], enc.shape[1])
    np.testing.assert_allclose(maps.numpy(), np.asarray(jmaps), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jtprobs), atol=1e-5, rtol=0)


class StandInSeam:
    """The capture seam's stand-in (tests/test_torch_decode_graphs.py's):
    warm_up runs the body, capture counts itself and returns the body."""

    def __init__(self):
        self.captured = 0

    def warm_up(self, body):
        body()

    def capture(self, body):
        self.captured += 1
        return body


def test_runner_keys_and_refills_for_the_options(model):
    _, tp, enc = model
    std = CFG.prompt_ids("english")
    width, total = len(std) + 4, len(std) + 4 + 6
    seams = []

    def factory():
        seams.append(StandInSeam())
        return seams[-1]

    run = graphs.DecodeRunner(tp, CFG, capture=factory)
    INT8 = dict(cross_kv_int8=True, self_kv_int8=True)
    opts = dict(with_logprobs=True, with_no_speech=True, max_gen_tokens=5, segment=3)
    cases = [(len(std), 0.0, 3), (len(std) + 3, 0.0, 4), (len(std) + 2, 0.6, 4),
             (len(std), 1.0, 8)]
    for plen, temp, seed in cases:
        ids = [CFG.prev_sot_token_id, 140, 141][:plen - len(std)] + std
        buf = np.full((B, width), CFG.eos_token_id, np.int64)
        buf[:, :plen] = ids
        kw = dict(prompt_len=plen, temperature=temp, seed=seed,
                  no_speech_pos=plen - len(std), **opts)
        got = run.greedy(run.prep(t(enc), total, **INT8), buf, **kw)
        want = greedy_decode_from_cache(tp, tw.init_cache(tp, t(enc), CFG, total, **INT8),
                                        CFG, buf, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # Every prompt length, temperature and seed: one key, one seam.
    assert len(seams) == 1 and len(run._programs) == 1
    buf[:, :len(std)] = std
    run.greedy(run.prep(t(enc), total, **INT8), buf, prompt_len=len(std), seed=0,
               timestamps=True, **opts)
    run.greedy(run.prep(t(enc), total, **INT8), buf, prompt_len=len(std), **opts)
    assert len(seams) == 3 and len(run._programs) == 3
    with pytest.raises(ValueError, match="seed"):
        run.greedy(run.prep(t(enc), total, **INT8), buf, temperature=0.5)
