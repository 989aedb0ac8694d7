#!/usr/bin/env python3
"""Smoke run of the sar_tpu_torch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and exits non-zero:

1. device: requires CUDA (no CPU fallback), prints the card's name and its
   `nvidia-smi --query-gpu=name,power.limit` line, turns TF32 off.
2. build: compiles sar_tpu_torch/csrc/*.cu with nvcc (first use) and prints
   the seconds it took.
3. kernels: K1 (encoder attention), K2 (cross-KV projection + int8
   quantization) and K3 (cross-attention decode) at whisper-small shapes,
   batch 8, each against its plain PyTorch version on the card in bf16,
   with error limits and median CUDA-event times over 20 runs.
4. end to end: random bf16 whisper-small (seeded), two batches of 8 random
   30 s clips through the port's ASREvaluator (mel -> encode(flash="hm") ->
   init_cache -> greedy, 64 new tokens), with the three launch counters
   zeroed before and read after; then the first batch through the plain
   path, compared in lockstep (both paths fed the same tokens) and free
   running.
5. result: one JSON line with every kernel's numbers, then the last line
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

MODEL = "whisper-small"
BATCH = 8
N_BATCHES = 2
MAX_NEW_TOKENS = 64
SEED = 0
TIMING_RUNS = 20
SPIN_CYCLES = 50_000_000  # ~25 ms at the H100's clock: longer than any fn's host dispatch
# Tolerances, kernel vs its plain version on the same bf16 inputs. K1/K3:
# max|kernel - plain| and that over max|plain| (fp32 sums in another order
# plus the bf16 rounding of the outputs and of the probabilities). K2: int8
# values may differ by 1 where the two GEMMs sum in another order and land
# on either side of a .5 boundary; pad rows must be exactly 0 / scale 0.
ATTN_ABS_TOL = 2e-2
ATTN_REL_TOL = 2e-2
KV_FLIP_FRAC_TOL = 5e-3
KV_SCALE_REL_TOL = 1e-2
LOCKSTEP_MIN_AGREEMENT = 0.99


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def time_cuda(fn, runs: int = TIMING_RUNS, warmup: int = 3) -> float:
    """Median device milliseconds of `fn()` over `runs` runs, CUDA events.

    Before each run a spin kernel (~25 ms) holds the stream, so the host
    has enqueued all of fn's launches before the start event fires: the
    events then time the device running them back to back, not the host's
    dispatch (which, for a 40 us kernel, costs as much as the kernel)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this smoke run "
              "drives the CUDA kernels and has no CPU fallback",
              file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {name} | count {torch.cuda.device_count()} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | tf32 off")
    print(smi)
    return torch.device("cuda", 0), name, smi


def phase_build():
    from sar_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load()
    secs = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.BUILD_LOG.splitlines()
            if "registers" in ln]
    print(f"build: {secs:.1f} s ({len(_build.sources())} sources, "
          f"{'built' if _build.BUILD_SECONDS is not None else 'cached'}, "
          f"sm_90a) | ptxas: {' ; '.join(regs)}")


def _attn_errors(got, want):
    import torch
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not torch.isfinite(got.float()).all():
        fail("kernel output has non-finite values")
    return d, d / max(scale, 1e-30)


def phase_kernels(cfg, device, batch):
    """K1-K3 against their plain versions at the model's shapes."""
    import torch
    from sar_tpu_torch.models.whisper import cross_pad_len
    from sar_tpu_torch.ops import decode_cross, flash_enc, kv_init

    g = torch.Generator(device=device).manual_seed(SEED)
    bf16 = torch.bfloat16
    D, H = cfg.d_model, cfg.encoder_heads
    S = cfg.max_source_positions
    S_pad = cross_pad_len(S)
    L = cfg.decoder_layers
    hd = D // H
    rows = []

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=device) * std).to(bf16)

    # K1: q pre-scaled, garbage in the padded rows as in the encoder.
    q, k, v = randn(batch, S_pad, D, std=hd ** -0.5), randn(batch, S_pad, D), randn(batch, S_pad, D)
    got = flash_enc.encoder_attention_hm(q, k, v, n_heads=H, t_valid=S)
    want = flash_enc.encoder_attention_hm_reference(q, k, v, n_heads=H, t_valid=S)
    torch.cuda.synchronize()
    abs_err, rel_err = _attn_errors(got[:, :S], want[:, :S])
    ms = time_cuda(lambda: flash_enc.encoder_attention_hm(q, k, v, n_heads=H, t_valid=S))
    plain_ms = time_cuda(lambda: flash_enc.encoder_attention_hm_reference(q, k, v, n_heads=H, t_valid=S))
    print(f"K1 encoder_attention_hm [B={batch}, T_pad={S_pad}, D={D}, H={H}] bf16: "
          f"max_abs_err {abs_err:.3e} max_rel_err {rel_err:.3e} (tol {ATTN_ABS_TOL}) | "
          f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
    if abs_err > ATTN_ABS_TOL or rel_err > ATTN_REL_TOL:
        fail("K1 disagrees with its plain version")
    rows.append(dict(name="encoder_attention_hm", route="cuda",
                     source="sar_tpu_torch/csrc/flash_enc.cu",
                     replaces="sar_tpu/ops/flash_enc.py:90",
                     max_abs_err=abs_err, ms=ms, plain_ms=plain_ms))
    del q, k, v, got, want

    # K2: an LN-scale encoder output with zero pad rows, as init_cache builds.
    enc = randn(batch, S_pad, D)
    enc[:, S:] = 0
    wk, wv, bv = randn(L, D, D, std=0.02), randn(L, D, D, std=0.02), randn(L, D, std=0.02)
    got = kv_init.fused_kv_init(enc, wk, wv, bv, n_heads=H, t_valid=S)
    want = kv_init.fused_kv_init_reference(enc, wk, wv, bv, n_heads=H, t_valid=S)
    torch.cuda.synchronize()
    flip, deq_err, scale_err = 0.0, 0.0, 0.0
    for gq, gs, wq, ws in ((got[0], got[1], want[0], want[1]),
                           (got[2], got[3], want[2], want[3])):
        dq = (gq.int() - wq.int()).abs()
        if dq.max().item() > 1:
            fail(f"K2 int8 values differ by {dq.max().item()} (> 1)")
        flip = max(flip, (dq != 0).float().mean().item())
        if gq[:, :, S:].any() or gs[..., S:].any():
            fail("K2 pad rows are not 0 with scale 0")
        scale_err = max(scale_err, ((gs[..., :S] - ws[..., :S]).abs()
                                    / ws[..., :S]).max().item())
        deq = lambda q8, s: q8.float().reshape(L, batch, S_pad, H, hd) \
            * s.transpose(2, 3)[..., None]
        deq_err = max(deq_err, (deq(gq, gs) - deq(wq, ws)).abs().max().item())
    ms = time_cuda(lambda: kv_init.fused_kv_init(enc, wk, wv, bv, n_heads=H, t_valid=S))
    plain_ms = time_cuda(lambda: kv_init.fused_kv_init_reference(enc, wk, wv, bv, n_heads=H, t_valid=S))
    print(f"K2 fused_kv_init [L={L}, B={batch}, S_pad={S_pad}, D={D}] bf16->s8: "
          f"int8 |d|<=1 on {flip:.3e} of entries (tol {KV_FLIP_FRAC_TOL}) | "
          f"scale max_rel_err {scale_err:.3e} (tol {KV_SCALE_REL_TOL}) | pad rows 0/0 | "
          f"dequantized max_abs_err {deq_err:.3e} | kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
    if flip > KV_FLIP_FRAC_TOL or scale_err > KV_SCALE_REL_TOL:
        fail("K2 disagrees with its plain version")
    rows.append(dict(name="fused_kv_init", route="cuda",
                     source="sar_tpu_torch/csrc/kv_init.cu",
                     replaces="sar_tpu/ops/kv_init.py:191",
                     max_abs_err=deq_err, ms=ms, plain_ms=plain_ms))

    # K3: over the kernel-built cache, every layer checked, the last timed.
    kq, ks, vq, vs = got
    qd = randn(batch, D, std=hd ** -0.5)
    abs_err, rel_err = 0.0, 0.0
    for layer in range(L):
        o = decode_cross.cross_decode_attention_exact(qd, kq, ks, vq, vs, layer=layer, n_heads=H)
        r = decode_cross.cross_decode_reference_exact(qd, kq, ks, vq, vs, layer=layer, n_heads=H)
        a, rr = _attn_errors(o, r)
        abs_err, rel_err = max(abs_err, a), max(rel_err, rr)
    torch.cuda.synchronize()
    # Timed per call over a sweep of all L layers, as a decode step calls
    # it: the L slabs (L x 19 MB at whisper-small B=8) exceed the 50 MB L2,
    # so each call reads its slab from HBM as in the decode loop.
    def sweep(fn):
        return lambda: [fn(qd, kq, ks, vq, vs, layer=layer, n_heads=H) for layer in range(L)]
    ms = time_cuda(sweep(decode_cross.cross_decode_attention_exact)) / L
    plain_ms = time_cuda(sweep(decode_cross.cross_decode_reference_exact)) / L
    slab_mb = (2 * batch * S_pad * D + 2 * 4 * batch * H * S_pad) / 1e6
    print(f"K3 cross_decode_attention_exact [B={batch}, S_pad={S_pad}, D={D}, all {L} layers] "
          f"bf16 q, s8 cache: max_abs_err {abs_err:.3e} max_rel_err {rel_err:.3e} "
          f"(tol {ATTN_ABS_TOL}) | per call over a {L}-layer sweep: kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms | {slab_mb:.1f} MB of int8 slab + scales -> "
          f"{slab_mb / ms:.1f} GB/s")
    if abs_err > ATTN_ABS_TOL or rel_err > ATTN_REL_TOL:
        fail("K3 disagrees with its plain version")
    rows.append(dict(name="cross_decode_attention_exact", route="cuda",
                     source="sar_tpu_torch/csrc/decode_cross.cu",
                     replaces="sar_tpu/ops/decode_cross.py:219",
                     max_abs_err=abs_err, ms=ms, plain_ms=plain_ms))
    return rows


def decode_steps(tokens, cfg, prompt_len: int) -> int:
    """decode_step calls the greedy loop made: it stops once every row has
    emitted EOS after the prompt, or at total - 1."""
    total = tokens.shape[1]
    gen = tokens[:, prompt_len:] == cfg.eos_token_id
    if not bool(gen.any(1).all()):
        return total - 1
    first = gen.int().argmax(1) + prompt_len
    return min(int(first.max()), total - 1)


def phase_e2e(cfg, device, batch, n_batches, max_new_tokens, language="hindi"):
    import torch
    from sar_tpu_torch.evaluation import ASREvaluator
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.ops import decode_cross, flash_enc, kv_init
    from sar_tpu_torch.ops import mel as mel_ops

    g = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.perf_counter()
    params = whisper.init_params(cfg, g, device)
    n_params = whisper.param_count(params)
    params = whisper.cast_params(params, torch.bfloat16)
    audio = [torch.randn((batch, mel_ops.N_SAMPLES), generator=g, device=device) * 0.1
             for _ in range(n_batches)]
    ev = ASREvaluator(cfg, params, language=language,
                      max_new_tokens=max_new_tokens, device=device)
    if device.type == "cuda" and ev.flash != "hm":
        fail(f"the evaluator did not pick the kernel encoder (flash={ev.flash!r})")
    P = int(ev._prompt.shape[0])
    torch.cuda.synchronize()
    print(f"e2e setup: {cfg.name} random bf16 weights "
          f"({n_params / 1e6:.1f} M params) + "
          f"{n_batches} x {batch} clips of 30 s, {time.perf_counter() - t0:.1f} s")

    def run(evaluator, a):
        """mel -> prep -> dec, each phase fenced; returns tokens, seconds."""
        t = [time.perf_counter()]
        feats = mel_ops.log_mel_spectrogram(
            a, cfg.num_mel_bins, dtype=torch.bfloat16)[:, :, :cfg.num_audio_frames]
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        cache = evaluator.prep(feats)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        tokens = evaluator.dec(cache)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        return tokens, [b - a_ for a_, b in zip(t, t[1:])]

    # Warm-up batch (cuBLAS handles, allocator), not counted.
    run(ev, audio[0])
    flash_enc.LAUNCHES = kv_init.LAUNCHES = decode_cross.LAUNCHES = 0
    outs, wall = [], 0.0
    for i, a in enumerate(audio):
        t_b = time.perf_counter()
        tokens, (t_mel, t_prep, t_dec) = run(ev, a)
        dt = time.perf_counter() - t_b
        wall += dt
        steps = decode_steps(tokens, cfg, P)
        if tokens.shape != (batch, ev.total) or tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
            fail(f"batch {i}: bad token tensor {tuple(tokens.shape)}")
        print(f"e2e batch {i}: wall {dt * 1e3:.1f} ms (mel {t_mel * 1e3:.1f}, "
              f"prep {t_prep * 1e3:.1f}, decode {t_dec * 1e3:.1f} ms for {steps} steps "
              f"= {t_dec * 1e3 / steps:.3f} ms/token-step at batch {batch})")
        outs.append((tokens, steps, t_dec))
    counts = {"encoder_attention_hm": flash_enc.LAUNCHES,
              "fused_kv_init": kv_init.LAUNCHES,
              "cross_decode_attention_exact": decode_cross.LAUNCHES}
    audio_s = n_batches * batch * mel_ops.CHUNK_SECONDS
    ms_tok = 1e3 * sum(o[2] for o in outs) / sum(o[1] for o in outs)
    print(f"e2e: {audio_s} audio-s in {wall:.3f} s -> RTFx {audio_s / wall:.1f} | "
          f"{ms_tok:.3f} ms/token-step (batch {batch}) | launches {json.dumps(counts)}")
    zero = [k for k, n in counts.items() if n == 0]
    if zero:
        fail(f"the main path launched no {', '.join(zero)} kernel")

    # Lockstep: both paths fed the kernel path's tokens, argmax compared at
    # every generated position; then the plain path free-running.
    plain = ASREvaluator(cfg, params, language=language, max_new_tokens=max_new_tokens,
                         device=device, flash=False, kernels=False)
    tok_k, steps, _ = outs[0]
    feats = mel_ops.log_mel_spectrogram(
        audio[0], cfg.num_mel_bins, dtype=torch.bfloat16)[:, :, :cfg.num_audio_frames]
    cache_k, cache_p = ev.prep(feats), plain.prep(feats)
    agree, n, max_dlogit = 0, 0, 0.0
    with torch.no_grad():
        for pos in range(steps):
            lk, cache_k = whisper.decode_step(params, tok_k[:, pos], pos, cache_k, cfg, kernels=True)
            lp, cache_p = whisper.decode_step(params, tok_k[:, pos], pos, cache_p, cfg, kernels=False)
            if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
                fail(f"non-finite logits at step {pos}")
            if pos + 1 >= P:
                agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
                n += batch
                max_dlogit = max(max_dlogit, (lk - lp).abs().max().item())
    tok_p = run(plain, audio[0])[0]
    gen_k, gen_p = tok_k[:, P:], tok_p[:, P:]
    free = (gen_k == gen_p).float().mean().item()
    lock = agree / max(n, 1)
    print(f"e2e vs plain path (batch 0): lockstep argmax agreement {lock:.4f} "
          f"({agree}/{n} row-steps, need >= {LOCKSTEP_MIN_AGREEMENT}) | max |dlogit| "
          f"{max_dlogit:.4e} | free-running token agreement {free:.4f}")
    if lock < LOCKSTEP_MIN_AGREEMENT:
        fail("kernel path disagrees with the plain path")
    return counts


def main() -> int:
    device, name, _ = phase_device()
    import torch
    from sar_tpu_torch.models.config import get_config
    phase_build()
    cfg = get_config(MODEL)
    rows = phase_kernels(cfg, device, BATCH)
    counts = phase_e2e(cfg, device, BATCH, N_BATCHES, MAX_NEW_TOKENS)
    for r in rows:
        r["launches"] = counts[r["name"]]
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms")} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
