"""The port's HTTP server (sar_tpu_torch/scripts/serve.py) on the CPU at
whisper-test, against the JAX package's scripts/serve.py:

- end to end: the port's server and the JAX script's handler, both in
  front of one port service, give the same status codes and bodies for
  /healthz, POST /v1/transcribe (its text the service's own transcription
  of the audio decoded from the same bytes; latency aside), a bad WAV
  (400) and an unknown path (404); /stats carries the service's counters;
  503 (queue full) and 500 (a failed request) through a stand-in service;
- `wav_bytes_to_audio` against JAX's on the same 16-bit stereo 8 kHz bytes
  (1e-5, the resample tests' tolerance), 16 kHz mono bytes passed through,
  other sample widths refused;
- `parse_args`' defaults equal JAX's, `--device` in place of `--platform`
  (refused);
- `build_service`'s branches: routed from saved adapter and classifier
  directories (responses carry a detected language; a language without
  an adapter exits; int8 scores dropped with the service's warning), one
  adapter (--checkpoint), and the precision guards of JAX's
  test_service_precision_modes."""

import io
import json
import logging
import queue
import sys
import threading
import urllib.error
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper, random_bank

from sar_tpu_torch.models import classifier as tclf
from sar_tpu_torch.models import lora as tlora
from sar_tpu_torch.scripts import serve as port_serve
from sar_tpu_torch.serving import TranscriptionService

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import serve as jax_serve  # noqa: E402

CFG = get_config("whisper-test")
NEW = 6
LANGS = ("english", "german")


class IdTokenizer:
    """Every id as a word: the text shows every token decoded
    (CharTokenizer drops the special ids)."""

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def world():
    _, tp = jax_whisper(CFG, seed=0, w_scale=3.0)
    rng = np.random.default_rng(7)
    clips = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (6000, 9000, 4000)]
    return tp, clips


def _wav(audio, sr=16000, channels=1, width=2) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        dtype = {1: np.uint8, 2: np.int16}[width]
        scale = 127 if width == 1 else 32767
        w.writeframes((np.asarray(audio) * scale + (128 if width == 1 else 0))
                      .astype(dtype).tobytes())
    return buf.getvalue()


class _Servers:
    """The port's server and the JAX script's, each on a free port of
    127.0.0.1, in front of one service."""

    def __init__(self, service):
        self.servers = [port_serve.make_server(service, "127.0.0.1", 0),
                        jax_serve.make_server(service, "127.0.0.1", 0)]
        for s in self.servers:
            threading.Thread(target=s.serve_forever, daemon=True).start()

    def call(self, path, data=None):
        """[(status, body) of the port's server, (status, body) of JAX's]."""
        out = []
        for s in self.servers:
            host, port = s.server_address
            req = urllib.request.Request(f"http://{host}:{port}{path}", data=data,
                                         method="GET" if data is None else "POST")
            try:
                with urllib.request.urlopen(req, timeout=300) as r:
                    out.append((r.status, json.loads(r.read())))
            except urllib.error.HTTPError as e:
                out.append((e.code, json.loads(e.read())))
        return out

    def close(self):
        for s in self.servers:
            s.shutdown()
            s.server_close()


def test_http_end_to_end_equals_the_service_and_the_jax_handler(world):
    tp, clips = world
    svc = TranscriptionService(CFG, tp, IdTokenizer(), language="english", batch_size=2,
                               max_wait_ms=50.0, max_new_tokens=NEW, device="cpu")
    servers = _Servers(svc)
    try:
        (code, health), want = servers.call("/healthz")
        assert (code, health) == want == (200, {"ok": True})
        body = _wav(clips[0])
        (code, got), (want_code, want) = servers.call(
            "/v1/transcribe?language=german", body)
        assert code == want_code == 200
        assert set(got) == set(want) == {"text", "language", "seconds", "latency_ms"}
        latency = got.pop("latency_ms")
        want.pop("latency_ms")
        assert got == want and latency > 0
        audio = port_serve.wav_bytes_to_audio(body)
        assert got == {"text": svc.transcribe(audio, language="german"),
                       "language": "german", "seconds": round(len(audio) / 16000, 3)}
        (code, stats), (want_code, _) = servers.call("/stats")
        assert code == want_code == 200 and stats["requests"] == 3
        assert {"batches", "rows_served", "latency_ms_p50", "queue_depth"} <= set(stats)
        for path, data, status in (("/v1/transcribe", b"nope", 400),
                                   ("/v1/transcribe?language=klingon", body, 400),
                                   ("/nope", None, 404), ("/v1/other", body, 404)):
            got, want = servers.call(path, data)
            assert got == want and got[0] == status
    finally:
        servers.close()
        svc.close()


class _StandInService:
    """submit raises `error`; stats is a constant."""

    def __init__(self, error):
        self.error = error

    def submit(self, audio, language=None, block=True):
        raise self.error

    def stats(self):
        return {"requests": 0}


@pytest.mark.parametrize("error,status", [(queue.Full(), 503),
                                          (RuntimeError("device lost"), 500)])
def test_saturated_and_failed_requests_equal_jax(error, status, caplog):
    servers = _Servers(_StandInService(error))
    try:
        with caplog.at_level(logging.ERROR):
            got, want = servers.call("/v1/transcribe", _wav(np.zeros(1600, np.float32)))
        assert got == want and got[0] == status
        assert servers.call("/stats") == [(200, {"requests": 0})] * 2
    finally:
        servers.close()


def test_wav_bytes_to_audio_equals_jax():
    from threadpoolctl import threadpool_limits
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(8000) * 0.1).astype(np.float32)
    other = (rng.standard_normal(8000) * 0.1).astype(np.float32)
    stereo = _wav(np.stack([audio, other], axis=1).reshape(-1), sr=8000, channels=2)
    with threadpool_limits(1):
        got = port_serve.wav_bytes_to_audio(stereo)
        want = jax_serve.wav_bytes_to_audio(stereo)
    assert got.dtype == np.float32 and got.shape == want.shape and abs(len(got) - 16000) < 50
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    mono = _wav(audio)
    np.testing.assert_array_equal(port_serve.wav_bytes_to_audio(mono),
                                  jax_serve.wav_bytes_to_audio(mono))
    for fn in (port_serve.wav_bytes_to_audio, jax_serve.wav_bytes_to_audio):
        with pytest.raises(ValueError, match="16-bit"):
            fn(_wav(audio, width=1))


def test_parse_args_defaults_equal_jax(capsys):
    got, want = vars(port_serve.parse_args([])), vars(jax_serve.parse_args([]))
    assert got.pop("device") is None and want.pop("platform") is None
    got.pop("platform")
    assert got == want
    assert (got["kv_cache"], got["attn_scores"], got["batch_size"], got["max_wait_ms"],
            got["max_new_tokens"]) == ("int8", "bf16", 8, 10.0, 256)
    with pytest.raises(SystemExit):
        port_serve.parse_args(["--platform", "cpu"])
    assert "--device" in capsys.readouterr().err


def _args(*extra):
    return port_serve.parse_args(["--model", "whisper-test", "--language", "english",
                                  "--batch_size", "2", "--max_wait_ms", "50",
                                  "--max_new_tokens", str(NEW), "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def saved(world, tmp_path_factory):
    """Two single adapters and a two-language LID head, saved as the CLIs
    save them."""
    d = tmp_path_factory.mktemp("routed")
    lcfg = tlora.LoraConfig(r=4, alpha=8, dropout=0.0)
    for i, lang in enumerate(LANGS):
        _, bank = random_bank(CFG, 1, 4, seed=11 + i, std=0.2)
        tlora.save_adapter(d / lang, bank, lcfg, metadata={"language": lang})
    ccfg = tclf.ClassifierConfig(input_dim=CFG.d_model, hidden_dims=(16,), num_classes=2,
                                 dropout=0.0, languages=LANGS, encoder_layer=0)
    tclf.save_classifier(d / "lid", tclf.init_classifier(torch.Generator().manual_seed(5),
                                                         ccfg), ccfg)
    return d


def test_build_service_routed_from_saved_dirs(world, saved, caplog):
    tp, clips = world
    adapters = ["--adapters", *(f"{lang}={saved / lang}" for lang in LANGS)]
    with caplog.at_level(logging.WARNING):
        svc = port_serve.build_service(_args("--classifier", str(saved / "lid"), *adapters,
                                             "--attn_scores", "int8"),
                                       CFG, tp, IdTokenizer())
    servers = _Servers(svc)
    try:
        assert tuple(svc.router.languages) == LANGS
        assert svc.scores_int8 is False and "scores_int8" in caplog.text
        assert tlora.num_adapters(svc.router.bank) == 2 and svc.kv_int8
        (code, got), (want_code, want) = servers.call("/v1/transcribe", _wav(clips[1]))
        assert code == want_code == 200 and got["language"] in LANGS
        got.pop("latency_ms"), want.pop("latency_ms")
        assert got == want
        assert got["text"] == svc.transcribe(port_serve.wav_bytes_to_audio(_wav(clips[1])))
    finally:
        servers.close()
        svc.close()
    with pytest.raises(SystemExit, match="german"):
        port_serve.build_service(_args("--classifier", str(saved / "lid"), "--adapters",
                                       f"english={saved / 'english'}"),
                                 CFG, tp, IdTokenizer())


def test_build_service_adapter_and_precision_modes(world, saved):
    """--checkpoint serves one adapter; --kv_cache int4 and --attn_scores
    int8 build and serve (their plain versions on the CPU; approximations,
    so only the type is held), and the guards refuse int8 scores over
    int4 or the unquantized cache."""
    tp, clips = world
    tok = IdTokenizer()
    for extra in (["--checkpoint", str(saved / "english")], ["--kv_cache", "int4"],
                  ["--attn_scores", "int8"], ["--kv_cache", "bf16", "--num_beams", "2"]):
        with port_serve.build_service(_args(*extra), CFG, tp, tok) as svc:
            out = svc.transcribe(clips[0])
            assert isinstance(out, str) and out
            assert (svc._ev.lora is not None) == ("--checkpoint" in extra)
            assert svc.scores_int8 == ("--attn_scores" in extra)
            assert (svc.kv_int8, svc.kv_int4) == {"int4": (False, True), "bf16": (False, False)}.get(
                extra[1], (True, False))
    with pytest.raises(ValueError, match="int4"):
        port_serve.build_service(_args("--kv_cache", "int4", "--attn_scores", "int8"), CFG, tp, tok)
    with pytest.raises(ValueError, match="kv_int8"):
        port_serve.build_service(_args("--kv_cache", "bf16", "--attn_scores", "int8"), CFG, tp, tok)
