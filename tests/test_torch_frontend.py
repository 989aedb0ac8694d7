"""The port's one frontend (sar_tpu_torch/models/frontend.py) at every entry
point that starts from audio, on the CPU at whisper-test and owsm-test (fp32
weights, so the sites that compute in the weights' dtype and those that
compute in bf16 differ):

- each of the six sites (the evaluator's `from_audio`, the serving worker's
  `_features`, long-form's `window_features`, the streaming transcriber's
  `_features`, the benchmark CLI's `_mel` and the s8 gate's
  `gate_features`) gives what `features` gives for its audio, dtype, rows
  and window, bit for bit;
- at whisper-test each also equals the explicit composition the sites ran
  before the frontend had one home: stack and pad (or pad_or_trim), log-mel,
  crop;
- at owsm-test the service, long-form and streaming give the evaluator's
  ESPnet features;
- OWSM runs through long-form's fallback path and streaming, which read
  `window_features` and the streaming window;
- `from_audio` calls the frontend through its module attribute, which the
  benchmark's eval drivers wrap to time the frontend;
- `get_processor` refuses an ESPnet config, and `features` refuses an ESPnet
  window other than 30 s and params without "mvn";
- the one "auto" rule of `encode`'s flash.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch
from _torch_port import t  # noqa: F401  (pins torch to one thread)

from benchmarks import weights_owsm
from sar_tpu_torch.evaluation import ASREvaluator, longform
from sar_tpu_torch.evaluation.streaming import StreamingTranscriber
from sar_tpu_torch.models import ebranchformer, frontend, whisper
from sar_tpu_torch.models.base import get_processor
from sar_tpu_torch.models.config import get_config
from sar_tpu_torch.ops import fbank as fbank_ops
from sar_tpu_torch.ops import mel as mel_ops
from sar_tpu_torch.scripts import benchmark as bench_cli
from sar_tpu_torch.scripts import s8_gate
from sar_tpu_torch.serving import TranscriptionService

CPU = torch.device("cpu")
ROWS = 3


@pytest.fixture(scope="module")
def models():
    """config name -> (cfg, fp32 params)."""
    w = get_config("whisper-test")
    o = get_config("owsm-test")
    published = whisper.tree_map(lambda x: x.float(),
                                 weights_owsm.make(dataclasses.asdict(o), 11, "cpu"))
    return {"whisper-test": (w, whisper.init_params(w, torch.Generator().manual_seed(0), "cpu")),
            "owsm-test": (o, ebranchformer.port_params(published, o))}


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(3)
    return [rng.standard_normal(int(16000 * s)).astype(np.float32) * 0.1 for s in (7.3, 2.1)]


def _evaluator(cfg, params, clips):
    ev = ASREvaluator(cfg, params, max_new_tokens=2, device="cpu")
    ev._transcribe_batch = lambda feats, prompts: feats
    return ev.from_audio(clips), clips, dict(dtype=torch.float32)


def _service(cfg, params, clips):
    with TranscriptionService(cfg, params, batch_size=ROWS, max_new_tokens=2,
                              device="cpu") as svc:
        got = svc._features([types.SimpleNamespace(audio=c) for c in clips])
    return got, clips, dict(dtype=torch.float32, rows=ROWS)


def _longform(cfg, params, clips):
    got = longform.window_features(clips, cfg, CPU, ROWS, params=params)
    return got, clips, dict(dtype=torch.bfloat16, rows=ROWS)


def _streaming(cfg, params, clips):
    st = StreamingTranscriber(cfg, params, None, max_new_tokens=2, device="cpu")
    return (st._features(clips[0]), clips[:1],
            dict(dtype=torch.float32, samples=frontend.window_samples(cfg)))


def _benchmark_cli(cfg, params, clips):
    audio = torch.from_numpy(mel_ops.stack_pad_audio(clips))
    return bench_cli._mel(cfg, params, audio), audio, dict(dtype=torch.bfloat16)


def _s8_gate(cfg, params, clips):
    audio = (np.random.default_rng(2).standard_normal((2, mel_ops.N_SAMPLES)) * 0.1
             ).astype(np.float32)
    return s8_gate.gate_features(cfg, params, 2, CPU), audio, dict(dtype=torch.bfloat16)


SITES = {"evaluator": _evaluator, "service": _service, "longform": _longform,
         "streaming": _streaming, "benchmark_cli": _benchmark_cli, "s8_gate": _s8_gate}


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("name", ["whisper-test", "owsm-test"])
def test_every_site_gives_the_frontends_features(models, clips, name, site):
    cfg, params = models[name]
    got, audio, kw = SITES[site](cfg, params, clips)
    assert got.shape[-1] == cfg.num_audio_frames
    _equal(got, frontend.features(audio, cfg, params, device=CPU, **kw))


@pytest.mark.parametrize("site", SITES)
def test_whisper_sites_equal_the_explicit_composition(models, clips, site):
    cfg, params = models["whisper-test"]
    got, audio, kw = SITES[site](cfg, params, clips)
    samples = kw.get("samples", mel_ops.N_SAMPLES)
    if isinstance(audio, list):
        silent = [np.zeros(1, np.float32)] * (kw.get("rows", len(audio)) - len(audio))
        audio = torch.from_numpy(mel_ops.stack_pad_audio(audio + silent, samples))
    audio = mel_ops.pad_or_trim(torch.as_tensor(audio).float(), samples)
    want = mel_ops.log_mel_spectrogram(audio, cfg.num_mel_bins, dtype=kw["dtype"])
    _equal(got, want[:, :, :cfg.num_audio_frames])


@pytest.mark.parametrize("site", ["service", "longform", "streaming"])
def test_owsm_sites_give_the_evaluators_espnet_features(models, clips, site):
    cfg, params = models["owsm-test"]
    got, audio, kw = SITES[site](cfg, params, clips)
    silent = [np.zeros(1, np.float32)] * (kw.get("rows", len(audio)) - len(audio))
    want, _, _ = _evaluator(cfg, params, audio + silent)
    _equal(got, want.to(got.dtype))


@pytest.mark.parametrize("path", ["longform_fallback", "streaming"])
def test_owsm_runs_through_the_paths_that_read_window_features(models, path):
    """The weights' dtype comes from the decoder's embedding, which both
    encoders' params hold (Whisper's `conv1` is not OWSM's)."""
    cfg, params = models["owsm-test"]
    tok = types.SimpleNamespace(decode=lambda ids: " ".join(map(str, ids)))
    audio = np.random.default_rng(4).standard_normal(16000 * 35).astype(np.float32) * 0.1
    if path == "streaming":
        st = StreamingTranscriber(cfg, params, tok, language="english",
                                  max_new_tokens=3, device="cpu")
        st.feed(audio[:16000 * 4])
        text = st.finalize()
    else:
        text = longform.transcribe_long(audio, cfg, params, tok, language="english",
                                        max_new_tokens=3, fallback=True, device="cpu")
    assert text.strip()


@pytest.mark.parametrize("name", ["whisper-test", "owsm-test"])
def test_from_audio_calls_the_frontend_through_its_module_attribute(
        models, clips, name, monkeypatch):
    cfg, params = models[name]
    calls = []
    for owner, attr in ((mel_ops, "log_mel_spectrogram"), (fbank_ops, "fbank")):
        fn = getattr(owner, attr)

        def counted(*a, fn=fn, attr=attr, **k):
            calls.append(attr)
            return fn(*a, **k)
        monkeypatch.setattr(owner, attr, counted)
    _evaluator(cfg, params, clips)
    assert calls == (["fbank"] if cfg.frontend == "espnet" else ["log_mel_spectrogram"])


def test_get_processor_refuses_an_espnet_config():
    with pytest.raises(ValueError, match="MVN statistics"):
        get_processor("owsm-test", device="cpu")


@pytest.mark.parametrize("case", ["window", "no_mvn"])
def test_espnet_features_refuse_what_fbank_cannot_take(models, clips, case):
    cfg, params = models["owsm-test"]
    kw = dict(samples=16000) if case == "window" else {}
    with pytest.raises(ValueError, match="30 s" if case == "window" else "mvn"):
        frontend.features(clips, cfg, params if case == "window" else {},
                          dtype=torch.float32, device=CPU, **kw)


@pytest.mark.parametrize("flash,device,want", [
    ("auto", "cuda", "hm"), ("auto", "cpu", False), ("fq", "cuda", "fq"), (True, "cpu", True)])
def test_resolve_flash(flash, device, want):
    assert whisper.resolve_flash(flash, torch.device(device)) == want
