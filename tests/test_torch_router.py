"""The port's routed path (models/router.py, the LoRA hooks of
models/whisper.py, the single-adapter ASREvaluator) against sar_tpu on the
CPU, whisper-test at fp32 with the JAX-made weights, bank and classifier
bridged over: LID equal, the adapted encoder within 1e-4, adapted
decode_step logits within 1e-4 over 4 steps, routed `generate` tokens
exactly equal to JAX's own AdapterRouter.generate (greedy over the
unquantized default cache) on a mixed-adapter batch, and the routed
program the service runs (`decode`, over the int8 head-minor cache)
equal to JAX greedy_decode over that cache."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper, random_bank, t, to_numpy

from sar_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
from sar_tpu.decode.greedy import greedy_decode as jax_greedy
from sar_tpu.decode.greedy import transcribe_tokens as jax_transcribe_tokens
from sar_tpu.evaluation.evaluator import ASREvaluator as JaxEvaluator
from sar_tpu.models import classifier as jclf
from sar_tpu.models import lora as jlora
from sar_tpu.models import router as jrouter
from sar_tpu.models import whisper as jw
from sar_tpu.models.config import TARGET_LANGUAGES
from sar_tpu.ops import mel as jmel
from sar_tpu_torch.data import CharTokenizer
from sar_tpu_torch.evaluation import ASREvaluator
from sar_tpu_torch.models import classifier as tclf
from sar_tpu_torch.models import lora as tlora
from sar_tpu_torch.models import router as trouter
from sar_tpu_torch.models import whisper as tw
from sar_tpu_torch.models.convert import from_jax_params

CFG = get_config("whisper-test")
R, ALPHA = 4, 8
SCALE = ALPHA / R
IDX = np.asarray([0, 1, 2, 3], np.int32)            # every adapter once


@pytest.fixture(scope="module")
def world():
    jp, tp = jax_whisper(CFG, seed=0)
    jb, tb = random_bank(CFG, 4, R, seed=11)
    jccfg = jclf.ClassifierConfig(input_dim=CFG.d_model, hidden_dims=(16,),
                                  num_classes=4, languages=tuple(TARGET_LANGUAGES),
                                  encoder_layer=0)
    jcp = jclf.init_classifier(jax.random.PRNGKey(5), jccfg)
    router = trouter.AdapterRouter(
        CFG, tp, tb, tlora.LoraConfig(r=R, alpha=ALPHA), from_jax_params(to_numpy(jcp)),
        tclf.ClassifierConfig.from_dict(jccfg.to_dict()), device="cpu")
    mel = np.random.default_rng(7).standard_normal(
        (4, CFG.num_mel_bins, CFG.num_audio_frames)).astype(np.float32)
    return jp, tp, jb, tb, jccfg, jcp, router, mel


def test_detect_language_matches_jax(world):
    jp, _, _, _, jccfg, jcp, router, mel = world
    assert router.flash is False and router.device.type == "cpu"
    feats = router.extract_encoder_features(t(mel))
    want_feats = jclf.encode_features(jp, jnp.asarray(mel), CFG, layer_index=0)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), atol=1e-4, rtol=0)
    names, probs = router.detect_language(feats)
    want_idx, want_probs = jclf.predict(jcp, jccfg, want_feats)
    assert names == [TARGET_LANGUAGES[i] for i in np.asarray(want_idx)]
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_probs), atol=1e-5)
    idx, _ = router.route(t(mel))
    assert idx.tolist() == np.asarray(want_idx).tolist()


def test_adapted_encode_and_decode_steps_match_jax(world):
    jp, tp, jb, tb, *_, mel = world
    enc_j = jw.encode(jp, jnp.asarray(mel), CFG, lora=jb, adapter_idx=jnp.asarray(IDX),
                      lora_scale=SCALE)
    enc_t = tw.encode(tp, t(mel), CFG, lora=tb, adapter_idx=t(IDX), lora_scale=SCALE)
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j), atol=1e-4, rtol=0)
    base = jw.encode(jp, jnp.asarray(mel), CFG)
    assert np.abs(np.asarray(base) - np.asarray(enc_j)).max() > 1e-3   # adapted

    kw_j = dict(lora=jb, adapter_idx=jnp.asarray(IDX), lora_scale=SCALE)
    kw_t = dict(lora=tb, adapter_idx=t(IDX), lora_scale=SCALE)
    jc = jw.init_cache(jp, enc_j, CFG, max_len=16, cross_kv_int8=True,
                       self_kv_int8=True, head_minor=True, **kw_j)
    tc = tw.init_cache(tp, t(enc_j), CFG, max_len=16, cross_kv_int8=True,
                       self_kv_int8=True, **kw_t)
    toks = np.asarray([CFG.prompt_ids(l) for l in TARGET_LANGUAGES])
    for pos in range(4):
        lj, jc = jw.decode_step(jp, jnp.asarray(toks[:, pos], jnp.int32),
                                jnp.int32(pos), jc, CFG, **kw_j)
        lt, tc = tw.decode_step(tp, torch.from_numpy(toks[:, pos]), pos, tc, CFG, **kw_t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)


def _jax_router(world):
    jp, _, jb, _, jccfg, jcp, _, _ = world
    return jrouter.AdapterRouter(CFG, jp, jb, jlora.LoraConfig(r=R, alpha=ALPHA), jcp, jccfg)


def test_routed_generate_tokens_equal_jax(world):
    jp, _, jb, _, _, _, router, mel = world
    want = _jax_router(world).generate(jnp.asarray(mel), adapter_idx=jnp.asarray(IDX),
                                       max_new_tokens=10)
    got = router.generate(t(mel), adapter_idx=IDX, max_new_tokens=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The service's routed program: the int8 head-minor cache.
    idx = jnp.asarray(IDX)
    prompts = jnp.asarray([CFG.prompt_ids(l) for l in TARGET_LANGUAGES], jnp.int32)[idx]
    enc = jw.encode(jp, jnp.asarray(mel), CFG, lora=jb, adapter_idx=idx, lora_scale=SCALE)
    want8 = jax_greedy(jp, enc, CFG, prompts, max_new_tokens=10, lora=jb,
                       adapter_idx=idx, lora_scale=SCALE, cross_kv_int8=True,
                       self_kv_int8=True, head_minor=True)
    got8 = router.decode(router.encode(t(mel), torch.from_numpy(IDX).long()),
                         torch.from_numpy(IDX).long(), max_new_tokens=10)
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))
    # A forced language routes every row to that language's adapter.
    one = router.generate(t(mel), language="punjabi", max_new_tokens=10)
    np.testing.assert_array_equal(
        one.numpy(), router.generate(t(mel), adapter_idx=[2] * 4, max_new_tokens=10).numpy())
    # Without an index, LID picks the adapters.
    lid_idx, _ = router.route(t(mel))
    np.testing.assert_array_equal(
        router.generate(t(mel), max_new_tokens=10).numpy(),
        router.generate(t(mel), adapter_idx=lid_idx, max_new_tokens=10).numpy())
    # Teacher-forced forward without labels (hard): LID and the adapted
    # encoder (the strategies against JAX's: test_forward_strategies_match_jax).
    out = router.forward(t(mel))
    assert set(out) == {"probs", "adapter_idx", "encoder_out"}
    torch.testing.assert_close(out["encoder_out"], router.encode(t(mel), lid_idx))


def test_build_router_from_sar_tpu_checkpoints(world, tmp_path):
    jp, tp, *_ = world
    jccfg = jclf.ClassifierConfig(input_dim=CFG.d_model, hidden_dims=(16,), num_classes=2,
                                  languages=("english", "german"))
    jcp = jclf.init_classifier(jax.random.PRNGKey(6), jccfg)
    dirs = {}
    for i, (lang, r, alpha) in enumerate((("english", 4, 8), ("german", 8, 32))):
        jb, _ = random_bank(CFG, 1, r, seed=20 + i)
        jlora.save_adapter(tmp_path / lang, jb, jlora.LoraConfig(r=r, alpha=alpha))
        dirs[lang] = str(tmp_path / lang)
    want = jrouter.build_router_from_checkpoints(CFG, jp, dirs, jcp, jccfg)
    got = trouter.build_router_from_checkpoints(
        CFG, tp, dirs, from_jax_params(to_numpy(jcp)),
        tclf.ClassifierConfig.from_dict(jccfg.to_dict()), device="cpu")
    assert (got.lora_cfg.r, got.lora_cfg.alpha, got.lora_cfg.scale) == (8, 8, 1.0)
    assert got.lora_cfg.to_dict() == want.lora_cfg.to_dict()
    for side, hooks in got.bank.items():
        for hook, entry in hooks.items():
            for k in ("a", "b"):
                np.testing.assert_allclose(entry[k].numpy(),
                                           np.asarray(want.bank[side][hook][k]), atol=1e-7)
    # Saved by the port, the router loads in both packages.
    got.save(tmp_path / "router")
    back = trouter.AdapterRouter.load(tmp_path / "router", CFG, tp, device="cpu")
    jback = jrouter.AdapterRouter.load(tmp_path / "router", CFG, jp)
    assert back.languages == jback.languages == ["english", "german"]
    np.testing.assert_array_equal(back.bank["decoder"]["cross_v"]["b"].numpy(),
                                  np.asarray(jback.bank["decoder"]["cross_v"]["b"]))


def test_single_adapter_evaluator_matches_jax(world):
    """ASREvaluator(lora=...): adapter 0 for every row, its cross_v term in
    K4's broadcast form; the same tokens as the JAX evaluator."""
    jp, tp, jb, tb, *_ = world
    jone, tone = jlora.slice_adapter(jb, 1), tlora.slice_adapter(tb, 1)
    rng = np.random.default_rng(9)
    clips = [rng.standard_normal(16000).astype(np.float32) * 0.1,
             rng.standard_normal(24000).astype(np.float32) * 0.3]
    jev = JaxEvaluator(CFG, jp, JaxCharTokenizer(CFG), language="english",
                       max_new_tokens=10, lora=jone, lora_scale=SCALE)
    feats = jmel.log_mel_spectrogram(jnp.asarray(jmel.stack_pad_audio(clips)),
                                     CFG.num_mel_bins)[:, :, :CFG.num_audio_frames]
    tokens, _ = jev._decode(jp, jev._prep(jp, feats), jev._prompt)
    want = jax_transcribe_tokens(tokens, CFG, prompt_len=int(jev._prompt.shape[0]))
    ev = ASREvaluator(CFG, tp, CharTokenizer(CFG), language="english", max_new_tokens=10,
                      lora=tone, lora_scale=SCALE, device="cpu")
    assert ev.from_audio(clips) == [JaxCharTokenizer(CFG).decode(r) for r in want]
    jax.clear_caches()


# Teacher-forced routing (AdapterRouter.forward) against the JAX router on
# the same weights, bank, head, mel and labels (two positions of one row
# are -100 padding): hard, soft, and threshold at 0.0 (every row
# confident: hard) and 1.0 (none: soft). Tolerances: losses 1e-5
# relative, logits 2e-4 absolute (fp32 on the CPU, the teacher-forced
# passes summed in other orders), probabilities 1e-5.
@pytest.mark.parametrize("strategy,threshold", [("hard", 0.7), ("soft", 0.7),
                                                ("threshold", 0.0), ("threshold", 1.0)])
def test_forward_strategies_match_jax(world, strategy, threshold):
    jp, _, jb, _, jccfg, jcp, router, mel = world
    labels = np.random.default_rng(3).integers(10, 100, (4, 6)).astype(np.int32)
    labels[0, -2:] = -100
    jr = jrouter.AdapterRouter(CFG, jp, jb, jlora.LoraConfig(r=R, alpha=ALPHA), jcp, jccfg,
                               threshold=threshold)
    want = jr.forward(jnp.asarray(mel), jnp.asarray(labels), strategy=strategy)
    saved, router.threshold = router.threshold, threshold
    try:
        got = router.forward(t(mel), t(labels), strategy=strategy)
    finally:
        router.threshold = saved
    assert set(got) == set(want)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["logits"].detach().numpy(), np.asarray(want["logits"]),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(got["probs"].detach().numpy(), np.asarray(want["probs"]),
                               atol=1e-5)
    if "adapter_idx" in want:
        assert got["adapter_idx"].tolist() == np.asarray(want["adapter_idx"]).tolist()
    if "confident" in want:
        assert bool(got["confident"]) == bool(want["confident"]) == (threshold == 0.0)


def test_forward_without_labels_matches_jax(world):
    """Hard routing without labels returns the adapted encoder output, as
    JAX's does; soft (and threshold with an unconfident batch) needs
    labels and raises."""
    jp, _, jb, _, jccfg, jcp, router, mel = world
    want = _jax_router(world).forward(jnp.asarray(mel), strategy="hard")
    got = router.forward(t(mel), strategy="hard")
    np.testing.assert_allclose(got["encoder_out"].numpy(), np.asarray(want["encoder_out"]),
                               atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="requires labels"):
        router.forward(t(mel), strategy="soft")
    with pytest.raises(ValueError, match="Unknown routing strategy"):
        router.forward(t(mel), strategy="nearest")
