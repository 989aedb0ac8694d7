"""The port's HF interop (sar_tpu_torch/models/convert.py and base.py)
against sar_tpu's and against HF transformers itself, offline: tiny
random-init HF Whisper models built in the test (tests/_hf_tiny.py), no
hub access.

- `from_state_dict` / `from_hf_model` equal, leaf for leaf and exactly,
  `from_jax_params(sar_tpu convert.from_state_dict(...))`, with and without
  the `model.` prefix; `config_from_hf` and `alignment_heads_from_hf` equal
  JAX's on an HF config, a generation config and neither.
- The HF oracles, after the JAX tests' patterns and tolerances: the encoder
  within 2e-4 and the forward logits within 5e-4 of HF's
  (tests/test_whisper_parity.py); greedy and beam tokens equal to HF
  `generate`'s over the port's default unquantized cache
  (tests/test_generate_parity.py); the mel filter bank within 1e-6 and the
  log-mel within 2e-4 of `WhisperFeatureExtractor` (tests/test_mel.py); a
  PEFT adapter through `lora_from_peft` within 2e-4 of the PEFT forward
  (tests/test_peft_interop.py).
- `get_model_name` / `get_processor` against JAX's, and `load_base_model`'s
  real-size branch with a tiny HF model standing in for `from_pretrained`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hf_tiny import (make_tiny_model, peft_wrap, randomize_peft_lora, synth_mels,
                      tiny_hf_config)
from _torch_port import whisper_fields_equal

from sar_tpu.models import base as jbase
from sar_tpu.models import convert as jconvert
from sar_tpu_torch.decode import beam_decode, greedy_decode
from sar_tpu_torch.models import base as tbase
from sar_tpu_torch.models import convert as tconvert
from sar_tpu_torch.models import whisper as tw
from sar_tpu_torch.models.config import get_config
from sar_tpu_torch.ops import mel as tmel

EOS, SOT = 3, 4
PROMPT = [4, 11, 7]            # explicit decoder prompt (sot + arbitrary forced tokens)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.fixture(scope="module")
def tiny():
    """The tiny HF model of tests/test_generate_parity.py (EOS embedding
    biased so that sequences end), its config and the port's params."""
    hf_cfg = tiny_hf_config(vocab_size=256, eos=EOS, sot=SOT, frames=64)
    model = make_tiny_model(hf_cfg, seed=1)
    with torch.no_grad():
        model.model.decoder.embed_tokens.weight[EOS] += 0.4
    cfg = tconvert.config_from_hf(hf_cfg)
    return model, hf_cfg, cfg, tconvert.from_hf_model(model, cfg)


@pytest.mark.parametrize("prefixed", [True, False])
def test_state_dict_import_equals_the_jax_bridge(tiny, prefixed):
    model, _, cfg, _ = tiny
    sd = dict((model if prefixed else model.model).state_dict())
    assert any(k.startswith("model.") for k in sd) == prefixed
    got = tconvert.from_state_dict(sd, cfg)
    want = tconvert.from_jax_params(jconvert.from_state_dict(sd, jconvert.config_from_hf(
        model.config)))
    a, b = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype == torch.float32 and x.shape == y.shape, path
        assert x.is_contiguous(), path
        assert torch.equal(x, y), path
    own = tw.init_params(cfg, torch.Generator().manual_seed(0))
    assert [p for p, _ in _leaves(own)] == [p for p, _ in a]
    via_model = tconvert.from_hf_model(model, cfg)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(_leaves(via_model), a))


def test_config_and_alignment_heads_equal_jax(tiny):
    from transformers import GenerationConfig
    _, hf_cfg, cfg, _ = tiny
    want = jconvert.config_from_hf(hf_cfg)
    assert whisper_fields_equal(want, cfg) and cfg.alignment_heads is None
    heads = [[1, 0], [1, 3], [0, 2]]
    gen = GenerationConfig(alignment_heads=heads)
    assert tconvert.alignment_heads_from_hf(gen) == jconvert.alignment_heads_from_hf(gen) \
        == ((1, 0), (1, 3), (0, 2))

    class WithGeneration:                       # a model: heads on its generation config
        generation_config = gen
    assert tconvert.alignment_heads_from_hf(WithGeneration()) == ((1, 0), (1, 3), (0, 2))
    hf_cfg2 = tiny_hf_config(vocab_size=256, eos=EOS, sot=SOT)
    hf_cfg2.alignment_heads = heads
    assert tconvert.config_from_hf(hf_cfg2).alignment_heads == \
        jconvert.config_from_hf(hf_cfg2).alignment_heads == ((1, 0), (1, 3), (0, 2))
    assert tconvert.alignment_heads_from_hf(GenerationConfig()) is None


def test_encoder_and_forward_match_hf(tiny):
    model, hf_cfg, cfg, params = tiny
    mel = synth_mels(0, 2, hf_cfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 10))
    with torch.no_grad():
        enc_hf = model.model.encoder(torch.from_numpy(mel)).last_hidden_state
        logits_hf = model(input_features=torch.from_numpy(mel),
                          decoder_input_ids=torch.from_numpy(tokens)).logits
    enc = tw.encode(params, torch.from_numpy(mel), cfg)
    assert enc.shape == enc_hf.shape
    np.testing.assert_allclose(enc.numpy(), enc_hf.numpy(), atol=2e-4)
    logits = tw.forward(params, torch.from_numpy(mel), torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(logits.numpy(), logits_hf.numpy(), atol=5e-4)


def _hf_generate(model, mel, max_new_tokens, **kw):
    """GenerationMixin.generate (not Whisper's override) with an explicit
    decoder prompt, as tests/test_generate_parity.py drives it."""
    from transformers.generation import GenerationMixin
    dec = torch.tensor([PROMPT] * mel.shape[0], dtype=torch.long)
    with torch.no_grad():
        out = GenerationMixin.generate(model, input_features=torch.from_numpy(mel),
                                       decoder_input_ids=dec,
                                       max_new_tokens=max_new_tokens, do_sample=False,
                                       **kw)
    return out.numpy()


def _body(row):
    """Generated ids after the prompt, cut at (excluding) the first EOS."""
    body = list(row[len(PROMPT):])
    return body[:body.index(EOS)] if EOS in body else body


def _same_rows(theirs, ours):
    for i in range(ours.shape[0]):
        assert _body(theirs[i]) == _body(ours[i].tolist()), f"row {i}"


@pytest.mark.parametrize("suppress", [(), (9, 17, 30)])
def test_greedy_tokens_match_hf_generate(tiny, suppress):
    model, hf_cfg, cfg, params = tiny
    mel = synth_mels(7, 3, hf_cfg)
    kw = {"suppress_tokens": list(suppress)} if suppress else {}
    theirs = _hf_generate(model, mel, 16, num_beams=1, **kw)
    enc = tw.encode(params, torch.from_numpy(mel), cfg)
    ours = greedy_decode(params, enc, cfg, PROMPT, max_new_tokens=16,
                         suppress_ids=suppress)
    _same_rows(theirs, ours)


@pytest.mark.parametrize("num_beams,length_penalty,suppress,begin", [
    (2, 1.0, (), ()), (4, 0.0, (), ()), (3, -0.5, (), ()),
    (3, 1.0, (9, 17, 30, 44), (5, 8))])
def test_beam_tokens_match_hf_generate(tiny, num_beams, length_penalty, suppress, begin):
    model, hf_cfg, cfg, params = tiny
    mel = synth_mels(11, 3, hf_cfg)
    kw = {}
    if suppress:
        kw = {"suppress_tokens": list(suppress), "begin_suppress_tokens": list(begin)}
    theirs = _hf_generate(model, mel, 12, num_beams=num_beams,
                          length_penalty=length_penalty, early_stopping=False, **kw)
    enc = tw.encode(params, torch.from_numpy(mel), cfg)
    ours = beam_decode(params, enc, cfg, PROMPT, num_beams=num_beams, max_new_tokens=12,
                       length_penalty=length_penalty, suppress_ids=suppress,
                       begin_suppress_ids=begin)
    _same_rows(theirs, ours)


@pytest.fixture(scope="module")
def hf_fe():
    from transformers import WhisperFeatureExtractor
    return WhisperFeatureExtractor()             # offline: defaults, no hub access


def test_mel_filter_bank_matches_hf(hf_fe):
    ours = tmel.mel_filter_bank(80)
    assert ours.shape == np.asarray(hf_fe.mel_filters).shape == (201, 80)
    np.testing.assert_allclose(ours, np.asarray(hf_fe.mel_filters), atol=1e-6)


@pytest.mark.parametrize("seconds", [1.0, 7.3, 30.0])
def test_log_mel_matches_hf(hf_fe, seconds):
    rng = np.random.default_rng(int(seconds * 10))
    t = np.arange(int(16000 * seconds)) / 16000.0
    audio = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1337 * t)
             + 0.1 * rng.standard_normal(t.size)).astype(np.float32)
    theirs = hf_fe(audio, sampling_rate=16000, return_tensors="np")["input_features"][0]
    ours = tmel.log_mel_spectrogram(tmel.pad_or_trim(torch.from_numpy(audio)), 80)[0]
    assert ours.shape == theirs.shape == (80, 3000)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=2e-4)


def test_peft_forward_through_lora_from_peft(tmp_path):
    hf_cfg = tiny_hf_config(vocab_size=256, eos=EOS, sot=SOT)
    model = make_tiny_model(hf_cfg, seed=5)
    cfg = tconvert.config_from_hf(hf_cfg)
    params = tconvert.from_hf_model(model, cfg)
    pm = peft_wrap(model, r=4, alpha=8)
    randomize_peft_lora(pm, seed=7)
    pm.save_pretrained(tmp_path)
    bank, lcfg = tconvert.lora_from_peft(tmp_path, cfg)
    assert (lcfg.r, lcfg.alpha) == (4, 8)
    assert set(bank["encoder"]) == {"q", "v"}
    assert set(bank["decoder"]) == {"self_q", "self_v", "cross_q", "cross_v"}
    mel = synth_mels(3, 2, hf_cfg)
    dec = [[SOT, 10, 20, 30], [SOT, 7, 9, 11]]
    with torch.no_grad():
        theirs = pm(input_features=torch.from_numpy(mel),
                    decoder_input_ids=torch.tensor(dec)).logits.numpy()
    lora = tconvert.from_jax_params(bank)
    ours = tw.forward(params, torch.from_numpy(mel), torch.tensor(dec), cfg, lora=lora,
                      lora_scale=lcfg.scale).numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=2e-4)
    base = tw.forward(params, torch.from_numpy(mel), torch.tensor(dec), cfg).numpy()
    assert np.abs(ours - base).max() > 1e-3      # the delta is not silently empty


def test_model_name_and_processor_equal_jax():
    for name in ("whisper-large", "whisper-small", "whisper-test", "org/custom"):
        assert tbase.get_model_name(name) == jbase.get_model_name(name)
    features, tok = tbase.get_processor("whisper-test", language="english", device="cpu")
    jfeatures, jtok = jbase.get_processor("whisper-test", language="english")
    audio = np.random.default_rng(3).standard_normal((2, tmel.N_SAMPLES)).astype(np.float32)
    got = features(audio)
    assert got.shape == (2, 80, 3000) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(jfeatures(jnp.asarray(audio))),
                               atol=1e-4, rtol=0)
    ids = tok.encode("hi", language="english")
    assert ids == jtok.encode("hi", language="english")
    assert tok.decode(ids) == "hi"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_load_base_model_reads_the_local_checkpoint(tiny, monkeypatch, dtype):
    import transformers
    model, _, cfg, params = tiny
    calls = []

    def from_pretrained(hf_id, **kw):
        calls.append((hf_id, kw))
        return model
    monkeypatch.setattr(transformers.WhisperForConditionalGeneration, "from_pretrained",
                        staticmethod(from_pretrained))
    monkeypatch.setattr(tbase, "get_config", lambda name: cfg)
    got_cfg, got = tbase.load_base_model("whisper-small", dtype=dtype, device="cpu")
    assert calls == [("openai/whisper-small", {"local_files_only": True})]
    assert got_cfg is cfg
    want = params if dtype == torch.float32 else tw.cast_params(params, dtype)
    a, b = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def test_load_base_model_refuses_without_the_files(monkeypatch):
    import transformers

    def missing(hf_id, **kw):
        raise OSError(f"{hf_id} is not in the local cache")
    monkeypatch.setattr(transformers.WhisperForConditionalGeneration, "from_pretrained",
                        staticmethod(missing))
    with pytest.raises(NotImplementedError, match="weights .*openai/whisper-base"):
        tbase.load_base_model("whisper-base")
    assert get_config("whisper-base").d_model == 512
