"""The fused encoder path (`encode(flash="fq")`, kernel K8's plain version
on the CPU) against sar_tpu on whisper-test at fp32 with the JAX weights
bridged over, JAX's Pallas kernels in interpret mode: encode within 1e-4
(the layer's residual stream through two layers of fp32 sums in another
order), ASREvaluator(flash="fq") tokens equal to the JAX evaluator's, and
the routes: a bank on q/v turns "fq" into "hm" (torch.equal), an "o"-only
bank stays fused, a tap layer of encode_features takes "hm"."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper, random_bank, t
from jax.experimental.pallas import tpu as pltpu

from sar_tpu.evaluation.evaluator import ASREvaluator as JaxEvaluator
from sar_tpu.models import classifier as jclf
from sar_tpu.models import whisper as jw
from sar_tpu_torch.evaluation import ASREvaluator
from sar_tpu_torch.models import classifier as tclf
from sar_tpu_torch.models import whisper as tw

CFG = get_config("whisper-test")
B = 2


@pytest.fixture(scope="module")
def model():
    jp, tp = jax_whisper(CFG, seed=0, w_scale=5.0)
    mel = np.random.default_rng(7).standard_normal(
        (B, CFG.num_mel_bins, CFG.num_audio_frames)).astype(np.float32)
    return jp, tp, mel


def _count_fused(monkeypatch):
    calls = []
    real = tw.encoder_attention_fused
    monkeypatch.setattr(tw, "encoder_attention_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_encode_fq_matches_jax(model, monkeypatch):
    jp, tp, mel = model
    with pltpu.force_tpu_interpret_mode():
        want = jw.encode(jp, jnp.asarray(mel), CFG, flash="fq")
    calls = _count_fused(monkeypatch)
    got = tw.encode(tp, t(mel), CFG, flash="fq")
    assert len(calls) == CFG.encoder_layers           # K8 in every layer
    assert got.shape == (B, CFG.max_source_positions, CFG.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert torch.equal(got, tw.encode(tp, t(mel), CFG, flash="fq", kernels=False))


@pytest.mark.parametrize("targets,fused", [(("q_proj", "v_proj"), False),
                                           (("out_proj",), True)],
                         ids=["qv-bank-takes-hm", "o-bank-stays-fused"])
def test_fq_routes_with_an_encoder_bank(model, monkeypatch, targets, fused):
    jp, tp, mel = model
    jb, tb = random_bank(CFG, 2, 4, seed=5, targets=targets, std=0.3)
    idx = np.asarray([1, 0], np.int32)
    kw = dict(lora=tb, adapter_idx=t(idx), lora_scale=2.0)
    calls = _count_fused(monkeypatch)
    got = tw.encode(tp, t(mel), CFG, flash="fq", **kw)
    assert len(calls) == (CFG.encoder_layers if fused else 0)
    hm = tw.encode(tp, t(mel), CFG, flash="hm", **kw)
    if not fused:
        assert torch.equal(got, hm)
    with pltpu.force_tpu_interpret_mode():
        want = jw.encode(jp, jnp.asarray(mel), CFG, flash="fq", lora=jb,
                         adapter_idx=jnp.asarray(idx), lora_scale=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_encode_features_tap_takes_hm_and_the_last_layer_passes_fq(model, monkeypatch):
    jp, tp, mel = model
    tap = tclf.encode_features(tp, t(mel), CFG, layer_index=1, flash="fq")
    assert torch.equal(tap, tclf.encode_features(tp, t(mel), CFG, layer_index=1, flash="hm"))
    with pltpu.force_tpu_interpret_mode():
        want = jclf.encode_features(jp, jnp.asarray(mel), CFG, layer_index=1, flash="fq")
    np.testing.assert_allclose(tap.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    calls = _count_fused(monkeypatch)
    last = tclf.encode_features(tp, t(mel), CFG, layer_index=-1, flash="fq")
    assert len(calls) == CFG.encoder_layers
    assert torch.equal(last, tw.encode(tp, t(mel), CFG, flash="fq"))


def test_unknown_flash_raises(model):
    _, tp, mel = model
    with pytest.raises(ValueError, match="flash"):
        tw.encode(tp, t(mel), CFG, flash="xx")


class IdTokenizer:
    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def test_evaluator_fq_equals_jax_evaluator(model):
    from sar_tpu.data.collate import create_collator as jax_collator
    from sar_tpu.data.loader import DataLoader as JaxLoader
    from sar_tpu.data.synthetic import SyntheticASRDataset as JaxSynthetic
    from sar_tpu_torch.data import DataLoader, SyntheticASRDataset, create_collator
    jp, tp, _ = model
    kw = dict(num_frames=CFG.num_audio_frames)
    port = DataLoader(SyntheticASRDataset(CFG, size=5, seed=5), 3,
                      create_collator(CFG.sot_token_id, **kw), shuffle=False, drop_last=False)
    jax_side = JaxLoader(JaxSynthetic(CFG, size=5, seed=5), 3,
                         jax_collator(CFG.sot_token_id, **kw), shuffle=False, drop_last=False)
    with pltpu.force_tpu_interpret_mode():
        want = JaxEvaluator(CFG, jp, IdTokenizer(), language="english", max_new_tokens=10,
                            flash="fq").evaluate(jax_side, return_predictions=True)
    ev = ASREvaluator(CFG, tp, IdTokenizer(), language="english", max_new_tokens=10,
                      flash="fq", device="cpu")
    assert ev.flash == "fq"
    got = ev.evaluate(port, return_predictions=True)
    assert got == want
    assert len(set(got["predictions"])) > 1            # the input matters
    jax.clear_caches()
