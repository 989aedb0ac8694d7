"""HTTP transcription server over the micro-batching service.

    python -m sar_tpu_torch.scripts.serve --model whisper-small \\
        --language hindi --port 8000

The port of scripts/serve.py, with its flags, routes and responses;
`--device` takes the place of `--platform` (default: the CUDA card). A
dependency-free stdlib HTTP API in front of sar_tpu_torch's
`TranscriptionService`:

  POST /v1/transcribe?language=hindi     body: a WAV file (16-bit PCM)
      -> {"text": ..., "language": ..., "seconds": ..., "latency_ms": ...}
  GET  /healthz                          -> {"ok": true}
  GET  /stats                            -> service counters + latency pcts

Each client connection blocks in its own handler thread
(ThreadingHTTPServer) while the rows of concurrent requests coalesce into
device batches: N clients cost ceil(N / batch_size) decode programs.
503 when the service's queue is full, 400 on a bad WAV, 404 elsewhere,
500 (with the traceback logged) on any other failure.

With --classifier/--adapters the server routes: per-request LID picks
each row's adapter and decoder prompt inside one batch, and the response
carries the detected language. With --checkpoint it serves one adapter.

`build_service` is the part after the base model and the tokenizer are
loaded, for in-process callers that bring their own (`main` loads them
with `load_base_model` and `get_tokenizer`).
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import queue
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from sar_tpu_torch.data import get_tokenizer
from sar_tpu_torch.data.preprocessing import resample
from sar_tpu_torch.device import resolve_device
from sar_tpu_torch.models import classifier as clf
from sar_tpu_torch.models import lora as lora_lib
from sar_tpu_torch.models.base import load_base_model
from sar_tpu_torch.models.router import build_router_from_checkpoints
from sar_tpu_torch.serving import TranscriptionService

logger = logging.getLogger("serve")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serve transcription over HTTP (PyTorch port)")
    p.add_argument("--model", type=str, default="whisper-small")
    p.add_argument("--language", type=str, default="hindi",
                   help="Default language when the request does not say")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="LoRA adapter dir (single-adapter serving)")
    p.add_argument("--classifier", type=str, default=None,
                   help="LID classifier dir -> routed serving")
    p.add_argument("--adapters", type=str, nargs="*", default=None,
                   metavar="LANG=DIR", help="Per-language adapter dirs "
                   "(routed serving, with --classifier)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=10.0)
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--num_beams", type=int, default=1)
    p.add_argument("--task", type=str, default="transcribe",
                   choices=["transcribe", "translate"],
                   help="translate = X -> English speech translation "
                        "(plain serving only; routed mode is "
                        "transcription-only)")
    p.add_argument("--kv_cache", type=str, default="int8",
                   choices=["int8", "bf16", "int4"],
                   help="KV-cache precision of the decode program (int4 = "
                        "nibble-packed, half the int8 traffic at coarser "
                        "quantization)")
    p.add_argument("--attn_scores", type=str, default="bf16",
                   choices=["bf16", "int8"],
                   help="int8 = s8 scores in the decode's cross-attention "
                        "(kernel K7; greedy non-routed serving; requires "
                        "int8 KV)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--platform", type=str, default=None, help=argparse.SUPPRESS)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    args = p.parse_args(argv)
    if args.platform is not None:
        p.error("--platform: not in sar_tpu_torch: use --device")
    return args


def wav_bytes_to_audio(data: bytes) -> np.ndarray:
    """Decode a WAV payload (16-bit PCM) to mono float32 at 16 kHz."""
    with wave.open(io.BytesIO(data), "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        frames = w.readframes(w.getnframes())
    if width != 2:
        raise ValueError(f"only 16-bit PCM wav supported, got width={width}")
    audio = np.frombuffer(frames, np.int16).astype(np.float32) / 32768.0
    if n_ch > 1:
        audio = audio.reshape(-1, n_ch).mean(axis=1)
    if sr != 16_000:
        audio = resample(audio, sr, 16_000)
    return audio


def build_service(args, cfg, params, tokenizer) -> TranscriptionService:
    """The service the flags ask for over the loaded model, on --device:
    routed (--classifier + --adapters), one adapter (--checkpoint) or
    plain."""
    device = resolve_device(args.device)
    precision = dict(kv_int8=args.kv_cache == "int8", kv_int4=args.kv_cache == "int4",
                     scores_int8=args.attn_scores == "int8")
    if args.classifier:
        clf_params, clf_cfg, _ = clf.load_classifier(args.classifier, device)
        adapter_dirs = dict(kv.split("=", 1) for kv in (args.adapters or []))
        missing = [lang for lang in clf_cfg.languages if lang not in adapter_dirs]
        if missing:
            raise SystemExit(f"--adapters missing for: {missing}")
        router = build_router_from_checkpoints(cfg, params, adapter_dirs, clf_params,
                                               clf_cfg, device=device)
        logger.info("routed serving over %s", clf_cfg.languages)
        # scores_int8 goes through so that the service's warning says it
        # was dropped for routed mode.
        return TranscriptionService(router=router, tokenizer=tokenizer,
                                    batch_size=args.batch_size,
                                    max_wait_ms=args.max_wait_ms,
                                    max_new_tokens=args.max_new_tokens, **precision)
    lora, lora_scale = None, 1.0
    if args.checkpoint:
        ckpt = Path(args.checkpoint)
        adapter = ckpt / "adapter" if (ckpt / "adapter").exists() else ckpt
        lora, lcfg, _ = lora_lib.load_any_adapter(adapter, cfg, device)
        lora_scale = lcfg.scale
        logger.info("adapter %s (r=%d alpha=%d)", adapter, lcfg.r, lcfg.alpha)
    return TranscriptionService(
        cfg, params, tokenizer, language=args.language, lora=lora,
        lora_scale=lora_scale, batch_size=args.batch_size,
        max_wait_ms=args.max_wait_ms, max_new_tokens=args.max_new_tokens,
        num_beams=args.num_beams, task=args.task, device=device, **precision)


class Handler(BaseHTTPRequestHandler):
    service = None                      # set by make_server

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj, ensure_ascii=False).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *fmt_args):  # route through logging
        logger.debug(fmt, *fmt_args)

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/healthz":
            self._json(200, {"ok": True})
        elif path == "/stats":
            self._json(200, self.service.stats())
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        url = urlparse(self.path)
        if url.path != "/v1/transcribe":
            self._json(404, {"error": "not found"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            audio = wav_bytes_to_audio(data)
            language = parse_qs(url.query).get("language", [None])[0]
            t0 = time.monotonic()
            req = self.service.submit(audio, language=language, block=False)
            text = req.result(timeout=600.0)
            self._json(200, {
                "text": text,
                "language": req.detected or language,
                "seconds": round(len(audio) / 16_000, 3),
                "latency_ms": round((time.monotonic() - t0) * 1e3, 1)})
        except queue.Full:
            self._json(503, {"error": "saturated, retry later"})
        except (wave.Error, EOFError, ValueError) as e:
            self._json(400, {"error": str(e) or type(e).__name__})
        except Exception as e:          # noqa: BLE001
            logger.exception("request failed")
            self._json(500, {"error": str(e)})


def make_server(service, host: str = "127.0.0.1", port: int = 0):
    """ThreadingHTTPServer bound to (host, port); port 0 picks a free one."""
    handler = type("BoundHandler", (Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg, params = load_base_model(args.model, dtype=torch.bfloat16, device=device)
    tokenizer = get_tokenizer(args.model, language=args.language)
    service = build_service(args, cfg, params, tokenizer)
    server = make_server(service, args.host, args.port)
    logger.info("serving on http://%s:%d (batch=%d, wait=%.0fms)",
                *server.server_address, args.batch_size, args.max_wait_ms)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
