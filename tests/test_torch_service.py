"""The port's TranscriptionService (serving/service.py) on the CPU,
whisper-test at fp32: requests from several threads coalesce into batches
and get the same tokens as the router or the evaluator called directly;
bad requests are refused at submit; close(drain=True) serves what was
queued; a failed batch hands its error to each of its requests. Also: the
entry points raise without CUDA unless given a device, and the new modules
import neither jax nor sar_tpu."""

import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper, random_bank, to_numpy

from sar_tpu.models import classifier as jclf
from sar_tpu_torch.decode import transcribe_tokens
from sar_tpu_torch.evaluation import ASREvaluator
from sar_tpu_torch.models import classifier as tclf
from sar_tpu_torch.models import lora as tlora
from sar_tpu_torch.models.convert import from_jax_params
from sar_tpu_torch.models.router import AdapterRouter
from sar_tpu_torch.ops import mel as tmel
from sar_tpu_torch.serving import TranscriptionService

CFG = get_config("whisper-test")
LANGS = ("english", "german")
NEW = 6


class _Tok:
    def decode(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def world():
    jp, tp = jax_whisper(CFG, seed=0)
    rng = np.random.default_rng(7)
    clips = [rng.standard_normal(int(n)).astype(np.float32) * 0.1
             for n in rng.integers(4000, 9000, size=6)]
    return tp, clips


@pytest.fixture(scope="module")
def router(world):
    tp, _ = world
    _, bank = random_bank(CFG, 2, 4, seed=3)
    jccfg = jclf.ClassifierConfig(input_dim=CFG.d_model, hidden_dims=(16,), num_classes=2,
                                  languages=LANGS)
    jcp = jclf.init_classifier(jax.random.PRNGKey(5), jccfg)
    return AdapterRouter(CFG, tp, bank, tlora.LoraConfig(r=4, alpha=8),
                         from_jax_params(to_numpy(jcp)),
                         tclf.ClassifierConfig.from_dict(jccfg.to_dict()), device="cpu")


def _feats(clips, batch):
    audio = tmel.stack_pad_audio(list(clips) + [np.zeros(1, np.float32)] * (batch - len(clips)))
    return tmel.log_mel_spectrogram(torch.from_numpy(audio), CFG.num_mel_bins)[
        :, :, :CFG.num_audio_frames]


def _from_threads(svc, clips, languages=None):
    out = [None] * len(clips)

    def ask(i):
        out[i] = svc.transcribe(clips[i], None if languages is None else languages[i],
                                timeout=300.0)
    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(clips))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return out


def test_routed_service_matches_the_router(world, router):
    _, clips = world
    with TranscriptionService(router=router, tokenizer=_Tok(), batch_size=6,
                              max_wait_ms=500.0, max_new_tokens=NEW) as svc:
        assert svc.device.type == "cpu"
        got = _from_threads(svc, clips)
        st = svc.stats()
    feats = _feats(clips, 6)
    idx, _ = router.route(feats)
    tokens = router.decode(router.encode(feats, idx), idx, NEW)
    want = [_Tok().decode(r) for r in transcribe_tokens(tokens, CFG, router.prompt_len)]
    assert got == want
    assert st["errors"] == 0 and st["rows_served"] == 6 and st["requests"] == 6
    assert st["latency_ms_p50"] <= st["latency_ms_p95"]


def test_greedy_service_matches_the_evaluator(world):
    tp, clips = world
    langs = ["english", "german", "german", "english", "german", "english"]
    with TranscriptionService(CFG, tp, language="english", batch_size=3,
                              max_wait_ms=300.0, max_new_tokens=NEW,
                              device="cpu") as svc:
        got = _from_threads(svc, clips, langs)
    ev = ASREvaluator(CFG, tp, language="english", max_new_tokens=NEW, device="cpu")
    prompts = torch.tensor([CFG.prompt_ids(l) for l in langs])
    tokens = ev.dec(ev.prep(_feats(clips, 6)), prompts)
    assert got == transcribe_tokens(tokens, CFG, len(CFG.prompt_ids("english")))


def test_submit_refuses_bad_requests_and_close_drains(world):
    tp, clips = world
    svc = TranscriptionService(CFG, tp, tokenizer=_Tok(), language="english",
                               batch_size=2, max_wait_ms=1.0, max_new_tokens=NEW,
                               device="cpu")
    with pytest.raises(ValueError, match="window"):
        svc.submit(np.zeros(CFG.num_audio_frames * 160 + 1, np.float32))
    with pytest.raises(ValueError):
        svc.submit(clips[0], language="klingon")
    reqs = [svc.submit(c) for c in clips[:4]]
    svc.close(drain=True)
    assert all(isinstance(r.result(timeout=0), str) for r in reqs)
    assert svc.stats()["rows_served"] == 4
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(clips[0])


def test_a_failed_batch_fans_its_error_out(world, monkeypatch):
    tp, clips = world
    svc = TranscriptionService(CFG, tp, batch_size=2, max_wait_ms=200.0,
                               max_new_tokens=NEW, device="cpu")

    def boom(batch):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(svc, "_run", boom)
    reqs = [svc.submit(c) for c in clips[:2]]
    for r in reqs:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            r.result(timeout=60.0)
    svc.close()
    assert svc.stats()["errors"] >= 1


def test_options_not_yet_ported_raise(world, router):
    tp, _ = world
    with pytest.raises(ValueError, match="greedily"):
        TranscriptionService(router=router, num_beams=2)
    # The unquantized cache is ported: the service runs over it.
    with TranscriptionService(CFG, tp, kv_int8=False, batch_size=1, max_new_tokens=NEW,
                              device="cpu") as svc:
        assert svc.kv_int8 is False and svc.kv_int4 is False
        assert isinstance(svc.transcribe(np.zeros(1600, np.float32), timeout=300), list)
    # The int4 cache is ported: the service runs over it.
    with TranscriptionService(CFG, tp, kv_int4=True, batch_size=1, max_new_tokens=NEW,
                              device="cpu") as svc:
        out = svc.transcribe(np.zeros(4000, np.float32), timeout=300.0)
    assert isinstance(out, list) and len(out) <= NEW
    with pytest.raises(ValueError):
        TranscriptionService(router=router, task="translate")


def test_entry_points_need_a_device_without_cuda(world, router, monkeypatch):
    tp, _ = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ASREvaluator(CFG, tp),
                 lambda: AdapterRouter(CFG, tp, router.bank, router.lora_cfg,
                                       router.clf_params, router.clf_cfg),
                 lambda: TranscriptionService(CFG, tp)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_port_modules_import_neither_jax_nor_sar_tpu():
    code = ("import sys\n"
            "import sar_tpu_torch.serving, sar_tpu_torch.models.router\n"
            "import sar_tpu_torch.models.classifier, sar_tpu_torch.models.lora\n"
            "import sar_tpu_torch.models.convert, sar_tpu_torch.evaluation\n"
            "import sar_tpu_torch.ops.attic.decode_self, sar_tpu_torch.ops.attic.attention\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'sar_tpu' or m.startswith('sar_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1], timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
