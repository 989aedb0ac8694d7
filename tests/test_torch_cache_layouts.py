"""The two caches the entry points gained, against sar_tpu on the CPU
(whisper-test at fp32, the JAX weights bridged over and scaled x5 so that
tokens depend on the input): the classic int8 cache
(`init_cache(cross_kv_int8=True, self_kv_int8=True, head_minor=False)`,
JAX's layout on a CPU and under meshes) built and read as JAX builds and
reads it, and the unquantized cache behind `kv_int8=False` in
ASREvaluator, TranscriptionService and `evaluate_model --kv_cache bf16`.
Tolerances: cache values equal up to a rare rounding flip (an int8 value
off by one where two fp32 sums of the projection land on either side of a
.5, at most 1e-3 of them), scales 1e-5 relative, logits 1e-4 absolute;
greedy and beam tokens, predictions and WER EXACTLY equal to JAX's."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper, t

from sar_tpu.data.collate import create_collator as jax_collator
from sar_tpu.data.loader import DataLoader as JaxLoader
from sar_tpu.data.synthetic import SyntheticASRDataset as JaxSynthetic
from sar_tpu.decode.beam import beam_decode as jax_beam
from sar_tpu.decode.greedy import greedy_decode as jax_greedy
from sar_tpu.evaluation.evaluator import ASREvaluator as JaxEvaluator
from sar_tpu.models import whisper as jw
from sar_tpu_torch.data import (CharTokenizer, DataLoader, SyntheticASRDataset,
                                create_collator)
from sar_tpu_torch.decode import beam_decode, greedy_decode
from sar_tpu_torch.evaluation import ASREvaluator
from sar_tpu_torch.models import whisper as tw

CFG = get_config("whisper-test")
B = 3
PROMPT = CFG.prompt_ids("english")
NEW = 10
INT8 = dict(cross_kv_int8=True, self_kv_int8=True)


@pytest.fixture(scope="module")
def model():
    jp, tp = jax_whisper(CFG, seed=0, w_scale=5.0)
    mel = np.random.default_rng(7).standard_normal(
        (B, CFG.num_mel_bins, CFG.num_audio_frames)).astype(np.float32)
    return jp, tp, jw.encode(jp, jnp.asarray(mel), CFG)


def test_int8_classic_cache_matches_jax(model):
    jp, tp, enc = model
    want = jw.init_cache(jp, enc, CFG, max_len=10, head_minor=False, self_batch=2 * B,
                         **INT8)
    got = tw.init_cache(tp, t(enc), CFG, max_len=10, head_minor=False, self_batch=2 * B,
                        **INT8)
    for name, a in got._asdict().items():
        b = np.asarray(getattr(want, name))
        assert tuple(a.shape) == b.shape, name
        if a.dtype == torch.int8:
            d = np.abs(a.numpy().astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, name
        else:
            assert a.dtype == torch.float32, name
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=0, err_msg=name)
    assert got.cross_k.shape == (CFG.decoder_layers, B, CFG.decoder_heads,
                                 enc.shape[1], CFG.d_model // CFG.decoder_heads)


@pytest.mark.parametrize("scores_int8", [False, True])
def test_decode_steps_over_the_int8_classic_cache_match_jax(model, scores_int8):
    """Greedy steps (and s8 scores, plain torch over the classic slabs as
    JAX's `_attention_int8_mxu`), then beam steps with the ancestry."""
    jp, tp, enc = model
    jc = jw.init_cache(jp, enc, CFG, max_len=8, head_minor=False, **INT8)
    tc = tw.init_cache(tp, t(enc), CFG, max_len=8, head_minor=False, **INT8)
    toks = np.asarray([PROMPT] * B)
    for pos in range(4):
        lj, jc = jw.decode_step(jp, jnp.asarray(toks[:, pos], jnp.int32), jnp.int32(pos), jc,
                                CFG, scores_int8=scores_int8)
        lt, tc = tw.decode_step(tp, torch.from_numpy(toks[:, pos]), pos, tc, CFG,
                                scores_int8=scores_int8)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
    if scores_int8:
        return
    K, T = 2, 8
    jc = jw.init_cache(jp, enc, CFG, max_len=T, head_minor=False, self_batch=B * K, **INT8)
    tc = tw.init_cache(tp, t(enc), CFG, max_len=T, head_minor=False, self_batch=B * K, **INT8)
    rng = np.random.default_rng(5)
    anc = rng.integers(0, K, size=(B, K, T)).astype(np.int32)
    for pos in range(4):
        anc[:, :, pos] = np.arange(K)
        tok = rng.integers(0, CFG.vocab_size, size=B * K)
        lj, jc = jw.decode_step(jp, jnp.asarray(tok, jnp.int32), jnp.int32(pos), jc, CFG,
                                beam_width=K, ancestry=jnp.asarray(anc))
        lt, tc = tw.decode_step(tp, torch.from_numpy(tok), pos, tc, CFG, beam_width=K,
                                ancestry=t(anc).long())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)


# Tokens, greedy and beams of 2 and 4, over the classic int8 cache (JAX
# with head_minor=False) and the unquantized one (no cache flags).
@pytest.mark.parametrize("num_beams", [1, 2, 4])
@pytest.mark.parametrize("cache", ["int8_classic", "unquantized"])
def test_tokens_equal_jax(model, cache, num_beams):
    jp, tp, enc = model
    kw = dict(head_minor=False, **INT8) if cache == "int8_classic" else {}
    if num_beams == 1:
        want = jax_greedy(jp, enc, CFG, jnp.asarray(PROMPT, jnp.int32), max_new_tokens=NEW,
                          **kw)
        got = greedy_decode(tp, t(enc), CFG, PROMPT, max_new_tokens=NEW, **kw)
    else:
        want = jax_beam(jp, enc, CFG, jnp.asarray(PROMPT, jnp.int32), num_beams=num_beams,
                        max_new_tokens=NEW, **kw)
        got = beam_decode(tp, t(enc), CFG, PROMPT, num_beams=num_beams, max_new_tokens=NEW,
                          **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len({tuple(r) for r in got[:, len(PROMPT):].tolist()}) > 1   # the input matters
    jax.clear_caches()


@pytest.mark.parametrize("num_beams", [1, 2])
def test_evaluator_unquantized_cache_equals_jax(model, num_beams):
    """ASREvaluator(kv_int8=False): predictions and WER equal to the JAX
    evaluator's over a synthetic split."""
    jp, tp, _ = model
    kw = dict(num_frames=CFG.num_audio_frames)
    port = DataLoader(SyntheticASRDataset(CFG, size=5, seed=5), 2,
                      create_collator(CFG.sot_token_id, **kw), shuffle=False, drop_last=False)
    jax_side = JaxLoader(JaxSynthetic(CFG, size=5, seed=5), 2,
                         jax_collator(CFG.sot_token_id, **kw), shuffle=False, drop_last=False)
    tok = CharTokenizer(CFG)
    want = JaxEvaluator(CFG, jp, tok, language="english", max_new_tokens=NEW,
                        num_beams=num_beams, kv_int8=False).evaluate(
                            jax_side, return_predictions=True)
    ev = ASREvaluator(CFG, tp, tok, language="english", max_new_tokens=NEW,
                      num_beams=num_beams, kv_int8=False, device="cpu")
    assert (ev.kv_int8, ev.kv_int4) == (False, False)
    assert ev.evaluate(port, return_predictions=True) == want
    jax.clear_caches()


def test_evaluate_cli_bf16_cache_runs(tmp_path):
    from sar_tpu_torch.scripts import evaluate_model
    out = tmp_path / "eval"
    res = evaluate_model.main([
        "--checkpoint", "none", "--model", "whisper-test", "--language", "english",
        "--data_sources", "synthetic", "--kv_cache", "bf16", "--device", "cpu",
        "--max_samples", "4", "--batch_size", "2", "--max_new_tokens", "6",
        "--output_dir", str(out)])
    assert res["num_samples"] == 4
    assert json.loads((out / "metrics.json").read_text())["num_samples"] == 4
