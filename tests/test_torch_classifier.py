"""The port's LID classifier (models/classifier.py) against sar_tpu on the
CPU with the JAX-made params bridged over: the three poolings with and
without a mask, the CNN front (conv layout HIO <-> [out, in, k], padding
k//2), the class-weight strategies and the weighted, smoothed CE within
1e-5; encode_features at layers -1, 0 and 2 with flash False and "hm"
within 1e-4; save/load in both directions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import t, to_numpy

from sar_tpu.models import classifier as jclf
from sar_tpu.models import whisper as jw
from sar_tpu.models.config import get_config
from sar_tpu_torch.models import classifier as tclf
from sar_tpu_torch.models.convert import from_jax_params

LANGS = ("a", "b", "c")


def _heads(**kw):
    jcfg = jclf.ClassifierConfig(input_dim=64, hidden_dims=(32, 16), num_classes=3,
                                 languages=LANGS, **kw)
    jp = jclf.init_classifier(jax.random.PRNGKey(1), jcfg)
    tcfg = tclf.ClassifierConfig.from_dict(jcfg.to_dict())
    return jcfg, jp, tcfg, from_jax_params(to_numpy(jp))


def _inputs(seed=0, B=4, T=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, 64)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 5:] = False
    mask[3, 2:] = False
    return x, mask, np.asarray([0, 2, 1, 2])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pooling,use_cnn", [("mean", False), ("max", False),
                                             ("attention", False), ("mean", True)])
def test_apply_matches_jax(pooling, use_cnn, masked):
    jcfg, jp, tcfg, tp = _heads(pooling=pooling, use_cnn=use_cnn, cnn_channels=24,
                                label_smoothing=0.1)
    x, mask, labels = _inputs()
    m = mask if masked else None
    want = jclf.apply_classifier(jp, jcfg, jnp.asarray(x),
                                 None if m is None else jnp.asarray(m),
                                 labels=jnp.asarray(labels))
    got = tclf.apply_classifier(tp, tcfg, t(x), None if m is None else t(m),
                                labels=t(labels))
    for k in ("logits", "probs", "loss"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0)
    if masked and not use_cnn:    # masked frames do not move the output
        x2 = x.copy()
        x2[~mask] = 999.0
        again = tclf.apply_classifier(tp, tcfg, t(x2), t(mask))["logits"]
        np.testing.assert_allclose(again.numpy(), got["logits"].numpy(), atol=1e-5)
    labels_t, _ = tclf.predict(tp, tcfg, t(x), None if m is None else t(m))
    names, _ = tclf.predict_language(tp, tcfg, t(x))
    assert labels_t.tolist() == np.asarray(jclf.predict(jp, jcfg, jnp.asarray(x), None if m is None else jnp.asarray(m))[0]).tolist()
    assert names == jclf.predict_language(jp, jcfg, jnp.asarray(x))[0]


@pytest.mark.parametrize("strategy", ["inverse_freq", "inverse_sqrt", "effective_samples"])
def test_class_weights_match_jax(strategy):
    counts = {"a": 100, "b": 10, "c": 1000}
    for kw in (dict(), dict(max_weight=2.0), dict(smoothing=0.3)):
        np.testing.assert_allclose(
            tclf.compute_class_weights_from_counts(counts, LANGS, strategy, **kw),
            jclf.compute_class_weights_from_counts(counts, LANGS, strategy, **kw),
            rtol=1e-6)
    with pytest.raises(ValueError):
        tclf.compute_class_weights_from_counts(counts, LANGS, "nope")


def test_weighted_smoothed_ce_matches_jax_and_torch():
    jcfg, jp, tcfg, tp = _heads(label_smoothing=0.1, class_weights=(2.0, 0.5, 1.0))
    x, _, labels = _inputs(1)
    want = jclf.apply_classifier(jp, jcfg, jnp.asarray(x), labels=jnp.asarray(labels))
    got = tclf.apply_classifier(tp, tcfg, t(x), labels=t(labels))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=1e-5)
    ce = torch.nn.CrossEntropyLoss(weight=torch.tensor([2.0, 0.5, 1.0]),
                                   label_smoothing=0.1)(got["logits"], t(labels))
    np.testing.assert_allclose(float(got["loss"]), float(ce), rtol=1e-5)


@pytest.fixture(scope="module")
def encoder():
    cfg = dataclasses.replace(get_config("whisper-test"), encoder_layers=3)
    jp = jw.init_params(jax.random.PRNGKey(2), cfg)
    mel = np.random.default_rng(3).standard_normal(
        (2, cfg.num_mel_bins, cfg.num_audio_frames)).astype(np.float32)
    return cfg, jp, from_jax_params(to_numpy(jp)), mel


@pytest.mark.parametrize("flash", [False, "hm"])
@pytest.mark.parametrize("layer", [-1, 0, 2])
def test_encode_features_matches_jax(encoder, layer, flash):
    cfg, jp, tp, mel = encoder
    want = jclf.encode_features(jp, jnp.asarray(mel), cfg, layer_index=layer)
    got = tclf.encode_features(tp, t(mel), cfg, layer_index=layer, flash=flash)
    assert got.shape == (2, cfg.max_source_positions, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="out of range"):
        tclf.encode_features(tp, t(mel), cfg, layer_index=3)


@pytest.mark.parametrize("saved_by", ["sar_tpu", "sar_tpu_torch"])
def test_save_load_across_packages(tmp_path, saved_by):
    jcfg, jp, tcfg, tp = _heads(use_cnn=True, cnn_channels=24, pooling="attention")
    x, mask, _ = _inputs(2)
    if saved_by == "sar_tpu":
        jclf.save_classifier(tmp_path / "c", jp, jcfg, metadata={"step": 7})
        params, cfg, meta = tclf.load_classifier(tmp_path / "c")
        got = tclf.apply_classifier(params, cfg, t(x), t(mask))["logits"].numpy()
    else:
        tclf.LanguageClassifier(tcfg, tp).save(tmp_path / "c", metadata={"step": 7})
        params, cfg, meta = jclf.load_classifier(tmp_path / "c")
        got = np.asarray(jclf.apply_classifier(params, cfg, jnp.asarray(x),
                                               jnp.asarray(mask))["logits"])
    assert cfg.to_dict() == jcfg.to_dict() and meta == {"step": 7}
    want = jclf.apply_classifier(jp, jcfg, jnp.asarray(x), jnp.asarray(mask))["logits"]
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    handle = tclf.LanguageClassifier.load(tmp_path / "c")
    np.testing.assert_allclose(handle(t(x), t(mask))["logits"].numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
