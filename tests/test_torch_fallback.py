"""The port's temperature fallback against sar_tpu's on the CPU (after
tests/test_fallback.py; whisper-test at fp32, the JAX weights bridged over
and scaled x5):

- compression_ratio, needs_retry and should_skip_silence equal to JAX's
  over a grid of texts, scores and thresholds;
- a T = 0 pass (the int8 head-minor cache, the unquantized one, and with
  the timestamp grammar): texts equal, each row's info equal (avg_logprob
  to 1e-4 relative, no_speech_prob to 1e-5);
- escalation: impossible thresholds take both to the last temperature;
  rows at or above n_valid never escalate;
- best_of: T = 0 ignores it (equal to JAX's), and at T > 0 each row keeps
  the candidate with the best average logprob among the passes the
  runner makes with the folded seeds;
- a conditioned call (a wider prompt buffer, prompt_len, <|sot|> after a
  <|startofprev|> context, the cap of max_new_tokens) equal to JAX's;
- ASREvaluator(fallback=True, best_of=2) and the evaluate CLI's --fallback
  --best_of 2 equal to JAX's, on a model confident enough (token
  embeddings x30) that no window escalates; with beams the fallback is
  turned off, as in JAX."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper

from sar_tpu.evaluation import fallback as jfb
from sar_tpu_torch.evaluation import fallback as tfb
from sar_tpu_torch.models import whisper as tw

CFG = get_config("whisper-test")
NEW = 8


class Tok:
    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def model():
    jp, tp = jax_whisper(CFG, seed=0, w_scale=5.0)
    mel = np.random.default_rng(3).standard_normal(
        (3, CFG.num_mel_bins, CFG.num_audio_frames)).astype(np.float32)
    return jp, tp, mel


def _confident(jp, tp, scale=30.0):
    """The same weights with the tied token embeddings scaled: peaked
    logits, average logprobs above -1, no escalation."""
    return ({**jp, "decoder": {**jp["decoder"],
                               "token_embed": jp["decoder"]["token_embed"] * scale}},
            {**tp, "decoder": {**tp["decoder"],
                               "token_embed": tp["decoder"]["token_embed"] * scale}})


def _same_info(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.keys() == w.keys()
        assert (g["temperature"], g["ids"], g["compression_ratio"]) == \
            (w["temperature"], w["ids"], w["compression_ratio"])
        np.testing.assert_allclose(g["avg_logprob"], w["avg_logprob"], rtol=1e-4)
        np.testing.assert_allclose(g["no_speech_prob"], w["no_speech_prob"], atol=1e-5)


def test_retry_and_skip_rules_equal_jax():
    loop = "la la la la la la la la "
    texts = ["", "ok text", loop, loop * 8, "the quick brown fox"]
    for text in texts:
        assert tfb.compression_ratio(text) == jfb.compression_ratio(text)
        for lp in (-5.0, -1.0, -0.1):
            for ns in (None, 0.1, 0.9):
                for cr_t, lp_t, ns_t in ((2.4, -1.0, 0.6), (None, None, None),
                                         (2.4, None, 0.6), (None, -1.0, None)):
                    kw = dict(compression_ratio_threshold=cr_t, logprob_threshold=lp_t,
                              no_speech_prob=ns, no_speech_threshold=ns_t)
                    assert tfb.needs_retry(text, lp, **kw) == jfb.needs_retry(text, lp, **kw)
                    row = {"avg_logprob": lp, **({} if ns is None else {"no_speech_prob": ns})}
                    kw = dict(no_speech_threshold=ns_t, logprob_threshold=lp_t)
                    assert (tfb.should_skip_silence(row, **kw)
                            == jfb.should_skip_silence(row, **kw))


@pytest.mark.parametrize("kv_int8,timestamps", [(True, False), (False, False), (True, True)])
def test_first_pass_equals_jax(model, kv_int8, timestamps):
    jp, tp, mel = model
    kw = dict(language="english", max_new_tokens=NEW, temperatures=(0.0,),
              kv_int8=kv_int8, timestamps=timestamps)
    got = tfb.transcribe_batch_with_fallback(CFG, tp, torch.from_numpy(mel), Tok(),
                                             device="cpu", **kw)
    want = jfb.transcribe_batch_with_fallback(CFG, jp, jnp.asarray(mel), Tok(),
                                              flash=False, **kw)
    assert got[0] == want[0] and len(set(got[0])) > 1
    _same_info(got[1], want[1])
    jax.clear_caches()


def test_escalation_and_n_valid_equal_jax(model):
    jp, tp, mel = model
    kw = dict(language="english", max_new_tokens=NEW, temperatures=(0.0, 0.5, 1.0),
              logprob_threshold=1e9, compression_ratio_threshold=None, n_valid=2)
    texts, info = tfb.transcribe_batch_with_fallback(CFG, tp, torch.from_numpy(mel), Tok(),
                                                     device="cpu", **kw)
    jtexts, jinfo = jfb.transcribe_batch_with_fallback(CFG, jp, jnp.asarray(mel), Tok(),
                                                       flash=False, **kw)
    assert [i and i["temperature"] for i in info] == [i and i["temperature"] for i in jinfo] \
        == [1.0, 1.0, None]
    assert texts[2] is None and jtexts[2] is None
    jax.clear_caches()


def test_best_of(model):
    jp, tp, mel = model
    kw = dict(language="english", max_new_tokens=NEW, logprob_threshold=None,
              compression_ratio_threshold=None)
    greedy = [tfb.transcribe_batch_with_fallback(CFG, tp, torch.from_numpy(mel), Tok(),
                                                 temperatures=(0.0,), best_of=n,
                                                 device="cpu", **kw) for n in (1, 5)]
    want = jfb.transcribe_batch_with_fallback(CFG, jp, jnp.asarray(mel), Tok(),
                                              temperatures=(0.0,), best_of=5, flash=False,
                                              **kw)
    assert greedy[0][0] == greedy[1][0] == want[0]
    _same_info(greedy[1][1], want[1])
    # At T > 0: the candidates are the runner's passes with the folded seeds.
    fb = tfb.FallbackTranscriber(CFG, tp, Tok(), temperatures=(0.7,), best_of=3, seed=11,
                                 device="cpu", **kw)
    _, info = fb(torch.from_numpy(mel))
    base = tw.fold_in(tw.fold_in(11, 1), 0)
    enc = fb.encode(torch.from_numpy(mel))
    prompt = CFG.prompt_ids("english")
    avgs = []
    for c in range(3):
        out = fb.runner.greedy(fb.runner.prep(enc, fb.total, **fb._flags), prompt,
                               temperature=0.7, seed=base if c == 0 else tw.fold_in(base, c),
                               with_logprobs=True, with_no_speech=True,
                               max_gen_tokens=NEW)
        avgs.append((out[1] / out[2].clamp_min(1)).numpy())
    best = np.max(avgs, axis=0)
    np.testing.assert_allclose([r["avg_logprob"] for r in info], best, rtol=1e-6)
    assert len({tuple(a) for a in np.round(avgs, 5)}) > 1       # the candidates differ


def test_conditioned_call_equals_jax(model):
    jp, tp, mel = model
    std = CFG.prompt_ids("english")
    ids = [CFG.prev_sot_token_id, 140, 141, 150, 151] + std
    width = len(ids) + 3
    buf = np.full((1, width), CFG.eos_token_id, np.int32)
    buf[0, :len(ids)] = ids
    kw = dict(language="english", max_new_tokens=5, temperatures=(0.0,), prompt_width=width)
    got = tfb.FallbackTranscriber(CFG, tp, Tok(), device="cpu", **kw)(
        torch.from_numpy(mel[:1]), prompt=buf, prompt_len=len(ids))
    want = jfb.FallbackTranscriber(CFG, jp, Tok(), flash=False, **kw)(
        jnp.asarray(mel[:1]), prompt=buf, prompt_len=len(ids))
    assert got[0] == want[0] and len(got[1][0]["ids"]) == 5
    _same_info(got[1], want[1])
    jax.clear_caches()


def test_evaluator_and_cli_fallback_equal_jax(model, monkeypatch, tmp_path):
    from sar_tpu.data.collate import create_collator as jax_collator
    from sar_tpu.data.loader import DataLoader as JaxLoader
    from sar_tpu.data.synthetic import SyntheticASRDataset as JaxSynthetic
    from sar_tpu.evaluation.evaluator import ASREvaluator as JaxEvaluator
    from sar_tpu_torch.data import (DataLoader, SyntheticASRDataset, create_collator,
                                    get_tokenizer)
    from sar_tpu_torch.evaluation import ASREvaluator
    jp, tp = _confident(*model[:2])
    tok = get_tokenizer("whisper-test")
    kw = dict(num_frames=CFG.num_audio_frames)
    port_loader = DataLoader(SyntheticASRDataset(CFG, size=5, seed=5), 3,
                             create_collator(CFG.sot_token_id, **kw), shuffle=False,
                             drop_last=False)
    jax_loader = JaxLoader(JaxSynthetic(CFG, size=5, seed=5), 3,
                           jax_collator(CFG.sot_token_id, **kw), shuffle=False,
                           drop_last=False)
    ev = ASREvaluator(CFG, tp, tok, language="english", max_new_tokens=NEW,
                      fallback=True, best_of=2, device="cpu")
    got = ev.evaluate(port_loader, return_predictions=True)
    want = JaxEvaluator(CFG, jp, tok, language="english", max_new_tokens=NEW,
                        fallback=True, best_of=2, flash=False).evaluate(
        jax_loader, return_predictions=True)
    assert got == want and ev.fallback
    _, info = ev._fallback(next(iter(port_loader.one_epoch()))["input_features"])
    assert {r["temperature"] for r in info} == {0.0}          # nothing escalated
    assert not ASREvaluator(CFG, tp, tok, num_beams=2, fallback=True, device="cpu").fallback
    with pytest.raises(ValueError, match="tokenizer"):
        ASREvaluator(CFG, tp, None, fallback=True, device="cpu")

    # The evaluate CLIs, both given these weights.
    import sar_tpu.models.base as jbase
    import sar_tpu_torch.models.base as tbase
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import evaluate_model as jax_cli

    from sar_tpu_torch.scripts import evaluate_model as port_cli
    monkeypatch.setattr(jbase, "load_base_model", lambda *a, **k: (CFG, jp))
    monkeypatch.setattr(tbase, "load_base_model", lambda *a, **k: (CFG, tp))
    argv = ["--checkpoint", "none", "--model", "whisper-test", "--language", "english",
            "--data_sources", "synthetic", "--max_samples", "5", "--batch_size", "2",
            "--max_new_tokens", str(NEW), "--mixed_precision", "no", "--fallback",
            "--best_of", "2", "--save_predictions"]
    got = port_cli.main(argv + ["--device", "cpu", "--output_dir", str(tmp_path / "p")])
    want = jax_cli.main(argv + ["--output_dir", str(tmp_path / "j")])
    assert got == want and got["num_samples"] == 5
    jax.clear_caches()
