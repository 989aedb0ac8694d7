#!/usr/bin/env python3
"""Smoke run of the sar_tpu_torch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--profile]

Phases, each printing its own line(s); any failure raises and exits non-zero:

1. device: requires CUDA (no CPU fallback), prints the card's name and its
   `nvidia-smi --query-gpu=name,power.limit` line, turns TF32 off.
2. build: compiles sar_tpu_torch/csrc/*.cu with nvcc (first use, one
   process per source, all at once) and prints the seconds it took.
3. kernels: K1 (encoder attention), K2 (cross-KV projection + int8
   quantization), K4 (K2 with a per-sample LoRA term on V, per-sample and
   broadcast slices of a 4-adapter r=16 bank), K3 (cross-attention
   decode), K5 (K3 with the queries of 4, then 5, beams folded per
   sample) and K7 (s8-scores cross-attention decode, greedy and 4 beams
   folded) at whisper-small shapes, batch 8, each against its plain
   PyTorch version on the card in bf16, with error limits, median
   CUDA-event times over 20 runs, the least time the card could take
   (bound) and, for K1, one library call computing the same function
   (scaled_dot_product_attention with the key mask; the port never calls
   it). K6 (training's blockwise attention: forward, dQ, dK/dV) at the
   three whisper-small training shapes (encoder 1500 x 1500, decoder
   causal 448 x 448, cross 448 x 1500, batch 8), each against its plain
   version and the output and gradients against autograd of the plain
   attention, with SDPA forward and forward + backward as the library
   yardstick. Then, on the random model of phase 4, K8 (the fused pre-LN
   + q/k/v projection + attention of encode(flash="fq")) on layer 0's
   params, x [8, 1536, 768] with 1500 valid rows, with two composite
   yardsticks (the hm route it replaces: plain LN and projections + K1;
   and F.layer_norm + 3 addmm + SDPA); K9 (the parked s8 self decode) over
   a 12-layer head-minor int8 self cache of max_len 448 at valid lengths
   1, 67 and 448; K10 (the parked flash decode) at the cross shape
   (H=12, S=1500), full and masked, with SDPA of one query row. K9 and
   K10 have no caller in either package and launch on no path.
4. greedy end to end: random bf16 whisper-small (seeded), two batches of 8
   random 30 s clips through the port's ASREvaluator (mel ->
   encode(flash="hm") -> the int8 cache -> greedy, 64 new tokens), with the
   launch counters zeroed before and read after; then the first batch
   through the plain path, compared in lockstep (both paths fed the same
   tokens) and free running.
5. routed end to end: the same model with a random 4-adapter bank (r=16,
   q_proj/v_proj, nonzero B) and a random LID head (layer 3, mean
   pooling) behind an AdapterRouter, 16 requests of 30 s audio submitted
   from 4 threads to a TranscriptionService (batches of 8, 64 new tokens),
   then the service's routed program with adapters [0,1,2,3,0,1,2,3]
   with its phases fenced, all with the launch counters zeroed before and read after
   (K1, K4, K3 > 0, K2 = 0); then the routed plain path (kernels=False,
   flash=False) in lockstep and free running, and the LID overhead.
6. beam evaluation end to end: 16 synthetic whisper-small items through
   the port's DataLoader and collator into ASREvaluator(num_beams=4,
   64 new tokens).evaluate after one warm-up batch, printing WER/CER (of
   random weights: the path, not the accuracy), RTFx and ms per
   token-step, with the launch counters zeroed before and read after
   (K1, K2, K5 > 0; K3, K4 = 0); then the first batch through the plain
   path in lockstep (both paths decode from one beam state, which the
   kernel path's selection advances) and free running.
7. train end to end: ASRTrainer.train on random bf16 whisper-small with a
   fresh single-adapter bank (r=16, alpha=32, dropout 0.1, q_proj/v_proj),
   synthetic items of 3000 frames, microbatches of 8 with labels padded to
   448, 2-step accumulation, 3 optimizer steps after 1 warmup step, eval at
   steps 0 and 3 over 8 items (32 new tokens), with the launch counters
   zeroed before and read after (K6 forward, dQ and dK/dV at the counts the
   design predicts; K1-K5 = 0); then ms per step, examples/s and a fenced
   step's forward / backward / optimizer split; then one microbatch with a
   nonzero-B bank and dropout 0 through the kernel path, the plain path
   (flash_attention="off") and the plain path in fp32, comparing the loss
   and every LoRA gradient.
8. s8 end to end (the opt-in quantized decode): the greedy cell's two
   batches through ASREvaluator(scores_int8=True), then one batch of 8 x 4
   beams through ASREvaluator(num_beams=4, scores_int8=True), each with the
   launch counters zeroed before and read after (K7 12 per decode step,
   K3/K5 0), RTFx and ms per token-step; each against its plain path in
   lockstep (greedy >= 0.99; beams: the best beam's rows and the near-tie
   rule of phase 6); the gate's readings (s8-vs-exact token agreement, max
   |logit delta| over the forced prompt steps), printed, not enforced; then
   one greedy batch over the int4 cache (kv_int4=True, plain torch): its
   token agreement with the exact int8 path and ms per token-step.
9. fq end to end: the greedy cell's two batches through
   ASREvaluator(flash="fq") with the launch counters zeroed before and
   read after (K8 12 per batch, K1 0, K2 1 per batch, K3 12 per step),
   and through ASREvaluator(flash="hm") in the same run (RTFx, prep ms
   and ms per token-step of each); the card's fq encoder against its
   plain route (kernels=False), the hm one's as the noise floor; the fq
   tokens in lockstep with the hm path (both round differently; rows
   equal reported); one batch with an encoder q/v adapter and
   flash="fq" (the downgrade: K8 0, K1 12); then one batch of 8 x 4
   beams through beam_decode with its defaults, the JAX package's
   unquantized classic cache in plain torch (every counter 0), ms per
   token-step.
10. result: one JSON line with every kernel's numbers, then the last line
   {"ok": true, "device": {...}}.

With --profile, the routed, beam and s8 phases also run PROFILE_STEPS
steady-state decode steps of the greedy, routed, beam and s8 paths under
torch.profiler (after the counted runs), and the train phase one optimizer
step, and print, for each, the wall and device time per step, the device
busy share and the kernels that take the most time.
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
# Routed cell: a 4-adapter bank named for the reference's languages, r=16,
# alpha=32 on q_proj/v_proj; B drawn N(0, LORA_B_STD) so the deltas move the
# logits (LoRA's own init leaves B = 0); the LID head of LID_BENCH.json's
# chosen default (encoder layer 3, mean pooling).
LORA_RANK, LORA_ALPHA, LORA_B_STD = 16, 32, 0.01
MIXED_ADAPTERS = [0, 1, 2, 3, 0, 1, 2, 3]
ROUTED_REQUESTS, ROUTED_THREADS = 16, 4
LID_LAYER = 3
PROFILE_STEPS = 10
# Published peaks of one H100 SXM (dense): the bound of a kernel is the
# larger of its FLOPs over the bf16 tensor-core rate and its bytes (each
# input read once, each output written once) over the HBM rate.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
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
# Beam lockstep: a disagreement whose top-2 gap is at most LOGIT_TIE_TOL in
# both paths' own logits counts as a near tie (about half the max |dlogit|
# of 3.8e-2 the greedy path shows between the kernel and plain paths).
LOGIT_TIE_TOL = 2e-2
# Beam cell: ASREvaluator(num_beams=BEAM_WIDTH) over BEAM_ITEMS synthetic
# whisper-small items (the JAX package's synthetic source, full width), in
# batches of BATCH. K5 is checked at the cell's width and at Whisper's usual 5.
BEAM_WIDTH = 4
BEAM_KERNEL_WIDTHS = (4, 5)
BEAM_ITEMS = 16
# Train cell: the CLI's label length (the decoder's T), microbatches of
# BATCH, TRAIN_ACCUM of them per step, TRAIN_STEPS steps after one warmup
# step, eval over TRAIN_EVAL_ITEMS items at steps 0 and TRAIN_STEPS.
TRAIN_LABEL_LEN = 448
TRAIN_ACCUM, TRAIN_STEPS = 2, 3
TRAIN_EVAL_ITEMS, TRAIN_EVAL_TOKENS = 8, 32
# K6 against its plain version on the same bf16 inputs, max |kernel - plain|
# over max |plain| (one bf16 ulp of the largest entry is 3.9e-3 to 7.8e-3):
# - the forward kernel: it rounds the unnormalised p to bf16 (as the JAX
#   kernel does), the plain version the normalised p; read 4.0e-3 to 5.1e-3
#   at the three shapes;
# - the dQ and dK/dV kernels, given the same lse and di: both sum the same
#   bf16 products in fp32 in the same order; read 0 (bit for bit) in every
#   run, so any wrong term (a dropped di, a missed tile) fails;
# - the kernel path (custom op + autograd) against autograd of the plain
#   attention: the gradients go through another formulation of the softmax
#   backward; read 1.3e-3 to 7.5e-3.
K6_FWD_REL_TOL = 1e-2
K6_BWD_REL_TOL = 1e-3
K6_PATH_GRAD_REL_TOL = 1.5e-2
# One microbatch, kernel path vs plain path (bf16; random whisper-small, 24
# layers of bf16 rounding in both): relative error of the loss, and per
# LoRA leaf the cosine of the two gradients and their relative norm
# difference. The kernel path read 8.2e-5, cosine 0.999957 and 1.3e-3; the
# bf16 plain path against its fp32 twin, 1.5e-6, 0.999933 and 1.7e-3 (printed
# each run as the noise floor). The limits sit about 10x above both.
TRAIN_LOSS_REL_TOL = 1e-3
TRAIN_GRAD_MIN_COS = 0.999
TRAIN_GRAD_NORM_REL_TOL = 1e-2
# K7 against its plain version on the same s8 inputs, max |kernel - plain|
# and that over max |plain|: the integer sums are exact on both sides, so
# what differs is the fp32 softmax's summation order, which moves a row's
# scale ps by an ulp (or a re-quantized probability across a .5 boundary)
# and with it the bf16 rounding of an output. Read 1.2e-4 / 1.25e-3 at
# K=1 and 2.4e-4 / 2.35e-3 at K=4 (largest entries ~0.1; one bf16 ulp of
# the largest entry is 3.9e-3 to 7.8e-3 of it): the limits sit ~4x above.
S8_ABS_TOL = 1e-3
S8_REL_TOL = 8e-3
S8_BEAM_WIDTH = 4
# K9 (the parked s8 self decode) at whisper-small's max_len, valid lengths
# 1, a middle one and max_len; K10 (the parked flash decode) at the cross
# shape, full and masked to K10_MASKED_LEN. K9 fails only where both its
# absolute and relative errors pass the K7 limits (its outputs reach ~3,
# where one bf16 ulp is 1.6e-2).
K9_LENGTHS = (1, 67, 448)
K10_MASKED_LEN = 750


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


def bound(flops: float, nbytes: float, peak_ops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


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
    # The library yardstick: SDPA on head-major views of the same tensors,
    # keys >= t_valid masked, q already scaled.
    heads = lambda x: x.view(batch, S_pad, H, hd).transpose(1, 2)
    key_mask = (torch.arange(S_pad, device=device) < S)[None, None, None, :]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        heads(q), heads(k), heads(v), attn_mask=key_mask, scale=1.0)
    lib_err = _attn_errors(sdpa().transpose(1, 2).reshape(batch, S_pad, D)[:, :S],
                           want[:, :S])[0]
    library_ms = time_cuda(sdpa)
    b_ms, b_by = bound(4.0 * batch * H * S * S * hd, 4 * batch * S_pad * D * 2)
    print(f"K1 encoder_attention_hm [B={batch}, T_pad={S_pad}, D={D}, H={H}] bf16: "
          f"max_abs_err {abs_err:.3e} max_rel_err {rel_err:.3e} (tol {ATTN_ABS_TOL}) | "
          f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms | library (SDPA, key mask) "
          f"{library_ms:.3f} ms, max_abs_err vs plain {lib_err:.3e} | bound {b_ms:.4f} ms ({b_by})")
    if abs_err > ATTN_ABS_TOL or rel_err > ATTN_REL_TOL:
        fail("K1 disagrees with its plain version")
    rows.append(dict(name="encoder_attention_hm", route="cuda",
                     source="sar_tpu_torch/csrc/flash_enc.cu",
                     replaces="sar_tpu/ops/flash_enc.py:90",
                     max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=library_ms))
    del q, k, v, got, want

    # K2: an LN-scale encoder output with zero pad rows, as init_cache builds.
    enc = randn(batch, S_pad, D)
    enc[:, S:] = 0
    wk, wv, bv = randn(L, D, D, std=0.02), randn(L, D, D, std=0.02), randn(L, D, std=0.02)
    k2 = lambda fn: lambda: fn(enc, wk, wv, bv, n_heads=H, t_valid=S)
    got = k2(kv_init.fused_kv_init)()
    flip, scale_err, deq_err = _kv_errors("K2", got, k2(kv_init.fused_kv_init_reference)(), S)
    ms = time_cuda(k2(kv_init.fused_kv_init))
    plain_ms = time_cuda(k2(kv_init.fused_kv_init_reference))
    kv_bytes = (batch * S_pad * D * 2 + 2 * L * D * D * 2 + L * D * 2
                + 2 * L * batch * S_pad * D + 2 * L * batch * H * S_pad * 4)
    b_ms, b_by = bound(4.0 * L * batch * S * D * D, kv_bytes)
    print(f"K2 fused_kv_init [L={L}, B={batch}, S_pad={S_pad}, D={D}] bf16->s8: "
          f"int8 |d|<=1 on {flip:.3e} of entries (tol {KV_FLIP_FRAC_TOL}) | "
          f"scale max_rel_err {scale_err:.3e} (tol {KV_SCALE_REL_TOL}) | pad rows 0/0 | "
          f"dequantized max_abs_err {deq_err:.3e} | kernel {ms:.3f} ms plain {plain_ms:.3f} ms"
          f" | bound {b_ms:.4f} ms ({b_by})")
    rows.append(dict(name="fused_kv_init", route="cuda",
                     source="sar_tpu_torch/csrc/kv_init.cu",
                     replaces="sar_tpu/ops/kv_init.py:191",
                     max_abs_err=deq_err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # K4: cross_v slices of a 4-adapter bank, per sample (the routed path)
    # and one slice broadcast over the batch (a single adapter).
    r = LORA_RANK
    bank_a = randn(L, 4, D, r, std=1.0 / r)
    bank_b = randn(L, 4, r, D, std=0.02)
    idx = torch.tensor(MIXED_ADAPTERS[:batch], device=device)
    scale = LORA_ALPHA / LORA_RANK
    forms = {"per-sample": (bank_a[:, idx].contiguous(), bank_b[:, idx].contiguous()),
             "broadcast": (bank_a[:, :1].contiguous(), bank_b[:, :1].contiguous())}
    k4 = lambda fn, va, vb: lambda: fn(enc, wk, wv, bv, n_heads=H, t_valid=S,
                                       va=va, vb=vb, lora_scale=scale)
    k4_ms, k4_err = {}, 0.0
    for form, (va, vb) in forms.items():
        got4 = k4(kv_init.fused_kv_init, va, vb)()
        want4 = k4(kv_init.fused_kv_init_reference, va, vb)()
        flip, scale_err, deq_err = _kv_errors(f"K4 {form}", got4, want4, S)
        if torch.equal(got4[2], got[2]):
            fail(f"K4 {form}: the LoRA term did not reach V")
        k4_err = max(k4_err, deq_err)
        k4_ms[form] = (time_cuda(k4(kv_init.fused_kv_init, va, vb)),
                       time_cuda(k4(kv_init.fused_kv_init_reference, va, vb)))
        print(f"K4 fused_kv_init_lora {form} [L={L}, B={batch}, S_pad={S_pad}, D={D}, "
              f"r={r}] bf16->s8: int8 |d|<=1 on {flip:.3e} of entries (tol "
              f"{KV_FLIP_FRAC_TOL}) | scale max_rel_err {scale_err:.3e} (tol "
              f"{KV_SCALE_REL_TOL}) | pad rows 0/0 | dequantized max_abs_err {deq_err:.3e}"
              f" | kernel {k4_ms[form][0]:.3f} ms plain {k4_ms[form][1]:.3f} ms")
        del got4, want4
    ms, plain_ms = k4_ms["per-sample"]
    b_ms, b_by = bound(4.0 * L * batch * S * D * (D + r), kv_bytes + 2 * L * batch * D * r * 2)
    print(f"K4 bound (per-sample slices) {b_ms:.4f} ms ({b_by})")
    rows.append(dict(name="fused_kv_init_lora", route="cuda",
                     source="sar_tpu_torch/csrc/kv_init.cu",
                     replaces="sar_tpu/ops/kv_init.py:172",
                     max_abs_err=k4_err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     broadcast_ms=k4_ms["broadcast"][0]))

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
    b_ms, b_by = bound(4.0 * batch * H * S * hd, slab_mb * 1e6 + 2 * batch * D * 2)
    print(f"K3 cross_decode_attention_exact [B={batch}, S_pad={S_pad}, D={D}, all {L} layers] "
          f"bf16 q, s8 cache: max_abs_err {abs_err:.3e} max_rel_err {rel_err:.3e} "
          f"(tol {ATTN_ABS_TOL}) | per call over a {L}-layer sweep: kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms | {slab_mb:.1f} MB of int8 slab + scales -> "
          f"{slab_mb / ms:.1f} GB/s | bound {b_ms:.4f} ms ({b_by})")
    if abs_err > ATTN_ABS_TOL or rel_err > ATTN_REL_TOL:
        fail("K3 disagrees with its plain version")
    rows.append(dict(name="cross_decode_attention_exact", route="cuda",
                     source="sar_tpu_torch/csrc/decode_cross.cu",
                     replaces="sar_tpu/ops/decode_cross.py:219",
                     max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # K5: the beam-folded twin, q [B, K, D] over the same slabs; the beam
    # phase's width, then Whisper's usual one. Checked on every layer and
    # timed per call over a 12-layer sweep, as K3.
    k5 = {}
    for K in BEAM_KERNEL_WIDTHS:
        qb = randn(batch, K, D, std=hd ** -0.5)
        abs_err, rel_err = 0.0, 0.0
        for layer in range(L):
            o = decode_cross.cross_decode_attention_exact(qb, kq, ks, vq, vs, layer=layer, n_heads=H)
            r = decode_cross.cross_decode_reference_exact(qb, kq, ks, vq, vs, layer=layer, n_heads=H)
            a, rr = _attn_errors(o, r)
            abs_err, rel_err = max(abs_err, a), max(rel_err, rr)
        torch.cuda.synchronize()
        def sweep_b(fn):
            return lambda: [fn(qb, kq, ks, vq, vs, layer=layer, n_heads=H) for layer in range(L)]
        ms = time_cuda(sweep_b(decode_cross.cross_decode_attention_exact)) / L
        plain_ms = time_cuda(sweep_b(decode_cross.cross_decode_reference_exact)) / L
        b_ms, b_by = bound(4.0 * batch * K * H * S * hd, slab_mb * 1e6 + 2 * 2 * batch * K * D)
        print(f"K5 cross_decode_attention_exact beam-folded [B={batch}, K={K}, S_pad={S_pad}, "
              f"D={D}, all {L} layers] bf16 q, s8 cache: max_abs_err {abs_err:.3e} max_rel_err "
              f"{rel_err:.3e} (tol {ATTN_ABS_TOL}) | per call over a {L}-layer sweep: kernel "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms | {slab_mb:.1f} MB of int8 slab + scales -> "
              f"{slab_mb / ms:.1f} GB/s | bound {b_ms:.4f} ms ({b_by}) | shared memory "
              f"{decode_cross.beam_shared_bytes(K, S_pad)} B")
        if abs_err > ATTN_ABS_TOL or rel_err > ATTN_REL_TOL:
            fail(f"K5 (K={K}) disagrees with its plain version")
        k5[K] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    rows.append(dict(name="cross_decode_attention_exact_beam", route="cuda",
                     source="sar_tpu_torch/csrc/decode_cross.cu",
                     replaces="sar_tpu/ops/decode_cross.py:219",
                     library_ms=None, beam_width=BEAM_WIDTH, **k5[BEAM_WIDTH],
                     other_widths={K: v for K, v in k5.items() if K != BEAM_WIDTH}))

    # K7: s8 scores over the same slabs, the query quantized per (row,
    # head) as decode_step does; greedy (q [B, D]) and 4 beams folded.
    from sar_tpu_torch.models.whisper import quantize_kv
    for K, row_name in ((1, "cross_decode_attention"), (S8_BEAM_WIDTH, "cross_decode_attention_beam")):
        qq, qs = quantize_kv(randn(batch, K, H, hd, std=hd ** -0.5))
        qq = qq.reshape(batch, K, D) if K > 1 else qq.reshape(batch, D)
        qs = qs.reshape(batch, K * H, 1)
        abs_err, rel_err = 0.0, 0.0
        for layer in range(L):
            o = decode_cross.cross_decode_attention(qq, qs, kq, ks, vq, vs, layer=layer, n_heads=H)
            r = decode_cross.cross_decode_reference(qq, qs, kq, ks, vq, vs, layer=layer, n_heads=H)
            a, rr = _attn_errors(o, r)
            abs_err, rel_err = max(abs_err, a), max(rel_err, rr)
        torch.cuda.synchronize()
        def sweep_s8(fn):
            return lambda: [fn(qq, qs, kq, ks, vq, vs, layer=layer, n_heads=H) for layer in range(L)]
        ms = time_cuda(sweep_s8(decode_cross.cross_decode_attention)) / L
        plain_ms = time_cuda(sweep_s8(decode_cross.cross_decode_reference)) / L
        b_ms, b_by = bound(4.0 * batch * K * H * S * hd,
                           slab_mb * 1e6 + batch * K * (D + 4 * H + 2 * D), PEAK_INT8_OPS)
        print(f"K7 cross_decode_attention s8 [B={batch}, K={K}, S_pad={S_pad}, D={D}, all {L} "
              f"layers] s8 q, s8 cache: max_abs_err {abs_err:.3e} max_rel_err {rel_err:.3e} "
              f"(tol {S8_ABS_TOL} abs, {S8_REL_TOL} rel) | per call over a {L}-layer sweep: "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms | {slab_mb:.1f} MB of int8 slab + scales -> "
              f"{slab_mb / ms:.1f} GB/s | bound {b_ms:.4f} ms ({b_by}) | shared memory "
              f"{decode_cross.s8_shared_bytes(K, S_pad)} B | library: none (no PyTorch call "
              f"takes s8 attention with per-row scales and re-quantized probabilities)")
        if abs_err > S8_ABS_TOL or rel_err > S8_REL_TOL:
            fail(f"K7 (K={K}) disagrees with its plain version")
        rows.append(dict(name=row_name, route="cuda",
                         source="sar_tpu_torch/csrc/decode_cross_s8.cu",
                         replaces="sar_tpu/ops/decode_cross.py:109", library_ms=None,
                         beam_width=K, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


# K6 at the three attentions of a whisper-small training step: (label, Tq,
# Tk, causal). The decoder's T is the CLI's label length.
K6_SHAPES = (("encoder", 1500, 1500, False), ("decoder self", TRAIN_LABEL_LEN,
                                               TRAIN_LABEL_LEN, True),
             ("cross", TRAIN_LABEL_LEN, 1500, False))
K6_REPLACES = "sar_tpu/ops/flash.py:52 flash_mha -> jax pallas/ops/tpu/flash_attention.py:"


def phase_k6(cfg, device, batch):
    """K6's three kernels at each training shape: the kernel path (custom op
    + autograd) against autograd of the plain attention, each kernel against
    its own plain version, times, bounds and SDPA's. Returns the three
    kernel rows, each headed by the encoder shape, with every shape under
    "shapes"."""
    import torch
    import torch.nn.functional as F
    from sar_tpu_torch.ops import flash

    g = torch.Generator(device=device).manual_seed(SEED + 3)
    H, hd = cfg.encoder_heads, cfg.d_model // cfg.encoder_heads
    per = {n: {} for n in K6_NAMES}
    for label, Tq, Tk, causal in K6_SHAPES:
        def heads(T, std):
            x = torch.randn((batch, T, H * hd), generator=g, device=device) * std
            return x.to(torch.bfloat16).view(batch, T, H, hd).transpose(1, 2)
        q, k, v, do = heads(Tq, hd ** -0.5), heads(Tk, 1.0), heads(Tk, 1.0), heads(Tq, 1.0)

        def with_grads(fn):
            xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
            o = fn(*xs, causal=causal)
            return (o, *torch.autograd.grad(o, xs, do))
        got, want = with_grads(flash.flash_mha), with_grads(flash.flash_mha_reference)
        torch.cuda.synchronize()
        path_err = {n: _attn_errors(a, b) for n, a, b in zip(("o", "dq", "dk", "dv"), got, want)}
        del got, want
        # Each kernel on its own against its plain version, same inputs.
        o_k, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
        di = (o_k.float() * do.float()).sum(-1).contiguous()
        args = (q, k, v, do, lse, di)
        fns = {"flash_attention_fwd": (lambda: flash.flash_attention_fwd(q, k, v, causal=causal),
                                       lambda: flash.flash_attention_fwd_reference(q, k, v, causal=causal)),
               "flash_attention_bwd_dq": (lambda: flash.flash_attention_bwd_dq(*args, causal=causal),
                                          lambda: flash.flash_attention_bwd_dq_reference(*args, causal=causal)),
               "flash_attention_bwd_dkv": (lambda: flash.flash_attention_bwd_dkv(*args, causal=causal),
                                           lambda: flash.flash_attention_bwd_dkv_reference(*args, causal=causal))}
        sdpa = lambda x, y, z: F.scaled_dot_product_attention(x, y, z, is_causal=causal, scale=1.0)

        def sdpa_fwd_bwd():
            xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
            return torch.autograd.grad(sdpa(*xs), xs, do)
        lib = {"fwd": time_cuda(lambda: sdpa(q, k, v)), "fwd+bwd": time_cuda(sdpa_fwd_bwd)}
        f = batch * H * Tq * Tk * hd * (0.5 if causal else 1.0)
        qb, kb, rb = 2 * batch * H * Tq * hd, 2 * batch * H * Tk * hd, 4 * batch * H * Tq
        bounds = {"flash_attention_fwd": bound(4 * f, 2 * qb + 2 * kb + rb),
                  "flash_attention_bwd_dq": bound(6 * f, 3 * qb + 2 * kb + 2 * rb),
                  "flash_attention_bwd_dkv": bound(8 * f, 2 * qb + 4 * kb + 2 * rb)}
        bwd_bound = bound(10 * f, 3 * qb + 4 * kb + 2 * rb)
        line = []
        for name, (kern, plain) in fns.items():
            a, b = kern(), plain()
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            err = max(_attn_errors(x, y)[1] for x, y in zip(a, b))
            abs_err = max(_attn_errors(x, y)[0] for x, y in zip(a, b))
            tol = K6_FWD_REL_TOL if name == "flash_attention_fwd" else K6_BWD_REL_TOL
            if err > tol:
                fail(f"K6 {name} ({label}) disagrees with its plain version: rel {err:.3e} "
                     f"(tol {tol})")
            del a, b
            ms, plain_ms = time_cuda(kern), time_cuda(plain)
            b_ms, b_by = bounds[name]
            per[name][label] = dict(max_abs_err=abs_err, max_rel_err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=b_ms, bound_by=b_by,
                                    library_ms=lib["fwd" if name == "flash_attention_fwd"
                                                   else "fwd+bwd"])
            line.append(f"{name[16:]} {ms:.3f} ms (plain {plain_ms:.3f}, bound {b_ms:.4f} "
                        f"{b_by}, rel err {err:.2e}, tol {tol})")
        path_tol = {n: K6_FWD_REL_TOL if n == "o" else K6_PATH_GRAD_REL_TOL for n in path_err}
        print(f"K6 {label} [B={batch}, H={H}, Tq={Tq}, Tk={Tk}, causal={causal}] bf16: "
              + " | ".join(line) + f" | whole backward bound (10 B.H.Tq.Tk.hd FLOPs) "
              f"{bwd_bound[0]:.4f} ms"
              f" | SDPA fwd {lib['fwd']:.3f} ms, fwd+bwd {lib['fwd+bwd']:.3f} ms | kernel path vs "
              "plain autograd rel err " + ", ".join(f"{n} {e[1]:.2e} (tol {path_tol[n]})"
                                                    for n, e in path_err.items()))
        if any(e[1] > path_tol[n] for n, e in path_err.items()):
            fail(f"K6 ({label}): the kernel path's output or gradients disagree with the plain "
                 f"version's")
        del q, k, v, do, o_k, lse, di
    lines = {"flash_attention_fwd": "758 (forward, kernel :342)",
             "flash_attention_bwd_dq": "1456 (backward dQ, kernel :1146)",
             "flash_attention_bwd_dkv": "1121 (backward dK/dV, kernel :796)"}
    return [dict(name=n, route="cuda", source="sar_tpu_torch/csrc/flash_attn.cu",
                 replaces=K6_REPLACES + lines[n], **per[n]["encoder"], shapes=per[n])
            for n in K6_NAMES]


def phase_train(cfg, params, device, batch, profile=False):
    """LoRA training at full width through ASRTrainer.train, the K6 counts
    against the design's, the step's phase split, and one microbatch's loss
    and LoRA gradients, kernel path against plain path. Returns the launch
    counts of the train run."""
    import numpy as np
    import torch
    from sar_tpu_torch.data import CharTokenizer, DataLoader, SyntheticASRDataset, create_collator
    from sar_tpu_torch.models import lora as lora_lib
    from sar_tpu_torch.training import ASRTrainer, Callback, TrainingArgs
    from sar_tpu_torch.models.whisper import tree_leaves as leaves
    from sar_tpu_torch.models.whisper import tree_map
    from sar_tpu_torch.training.optim import apply_updates

    class Recorder(Callback):
        def __init__(self):
            self.logs = []

        def on_step_end(self, trainer, step, logs):
            self.logs.append(logs)

    t0 = time.perf_counter()
    coll = create_collator(cfg.sot_token_id, pad_to_length=TRAIN_LABEL_LEN,
                           num_mels=cfg.num_mel_bins, num_frames=cfg.num_audio_frames,
                           device=device)
    train_loader = DataLoader(SyntheticASRDataset(cfg, size=2 * batch, language="english",
                                                  seed=SEED), batch, coll, seed=SEED)
    eval_loader = DataLoader(SyntheticASRDataset(cfg, size=TRAIN_EVAL_ITEMS, language="english",
                                                 seed=SEED + 1), batch, coll, shuffle=False,
                             drop_last=False)
    lcfg = lora_lib.LoraConfig(r=LORA_RANK, alpha=LORA_ALPHA, dropout=0.1,
                               target_modules=("q_proj", "v_proj"))
    g = torch.Generator(device=device).manual_seed(SEED + 4)
    bank = lora_lib.init_lora(g, cfg, lcfg)
    targs = dict(learning_rate=5e-4, warmup_steps=1, max_steps=TRAIN_STEPS,
                 eval_steps=TRAIN_STEPS, gradient_accumulation_steps=TRAIN_ACCUM,
                 max_new_tokens=TRAIN_EVAL_TOKENS, seed=SEED, device=str(device))
    rec = Recorder()
    tr = ASRTrainer(cfg, params, bank, lcfg, TrainingArgs(**targs), tokenizer=CharTokenizer(cfg),
                    language="english", callbacks=[rec])
    if not tr.flash or tr.compute_dtype != torch.bfloat16:
        fail(f"the trainer did not pick K6 in bf16 (flash={tr.flash}, {tr.compute_dtype})")
    n_train = sum(x.numel() for x in leaves(tr.lora))
    torch.cuda.synchronize()
    print(f"train setup: {cfg.name} bf16 base + LoRA r={LORA_RANK} q_proj/v_proj "
          f"({n_train / 1e6:.2f} M trainable, fp32 masters), microbatch {batch} x "
          f"{TRAIN_ACCUM}, labels {TRAIN_LABEL_LEN}, {TRAIN_STEPS} steps, "
          f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    hist = tr.train(train_loader, eval_loader)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = hist["loss"]
    gnorms = [lg["grad_norm"] for lg in rec.logs]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses + gnorms)):
        fail(f"train: losses {losses}, grad norms {gnorms}")
    if any(not bool(b.abs().max() > 0) for b in
           (e["b"] for side in tr.lora.values() for e in side.values())):
        fail("train: a LoRA B stayed 0")
    evals = hist["eval"]
    if [e["step"] for e in evals] != [0, TRAIN_STEPS] or not all(
            np.isfinite(e["eval_loss"]) and e["num_samples"] == TRAIN_EVAL_ITEMS
            for e in evals):
        fail(f"train: bad evaluations {evals}")
    n_attn = cfg.encoder_layers + 2 * cfg.decoder_layers
    n_eval_batches = -(-TRAIN_EVAL_ITEMS // batch)
    want_bwd = TRAIN_STEPS * TRAIN_ACCUM * n_attn
    want_fwd = want_bwd + len(evals) * n_eval_batches * cfg.encoder_layers
    step_s = hist["step_seconds"]
    ms_step = 1e3 * statistics.median(step_s[1:])
    fmt = lambda xs, f: ", ".join(format(x, f) for x in xs)
    print(f"train: {TRAIN_STEPS} steps in {wall:.2f} s with {len(evals)} evaluations | step "
          f"wall {fmt([x * 1e3 for x in step_s], '.1f')} ms -> {ms_step:.1f} ms per optimizer "
          f"step (median after the first) = {batch * TRAIN_ACCUM * 1e3 / ms_step:.2f} "
          f"examples/s | losses {fmt(losses, '.4f')} | grad norms {fmt(gnorms, '.4e')} | "
          f"eval_loss {fmt([e['eval_loss'] for e in evals], '.4f')}, WER "
          f"{fmt([e['wer'] for e in evals], '.3f')} | peak memory {peak_gb:.1f} GB | "
          f"launches {json.dumps(counts)}")
    check_counts("train", counts, want_zero=(*KERNEL_NAMES[:5], *K7_NAMES, *OFF_PATH))
    got = (counts["flash_attention_fwd"], counts["flash_attention_bwd_dq"],
           counts["flash_attention_bwd_dkv"])
    if got != (want_fwd, want_bwd, want_bwd):
        fail(f"train: K6 launches {got}, the design predicts ({want_fwd}, {want_bwd}, "
             f"{want_bwd}): one forward per attention (the checkpoint saves its output), one "
             f"dQ and one dK/dV per attention, and the evaluation encoder's forwards")

    # One more step with its phases fenced (not counted).
    micro = [b for _, b in zip(range(TRAIN_ACCUM), train_loader.one_epoch())]
    split = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}

    def fence():
        torch.cuda.synchronize()
        return time.perf_counter()
    g_sum = None
    for i, b in enumerate(micro):
        t = fence()
        loss = tr.microbatch_loss(b, i)
        t1 = fence()
        grads = torch.autograd.grad(loss, leaves(tr.lora))
        t2 = fence()
        split["forward"] += t1 - t
        split["backward"] += t2 - t1
        g_sum = grads if g_sum is None else [x + y for x, y in zip(g_sum, grads)]
    it = iter(g_sum)
    avg = tree_map(lambda _: next(it) / TRAIN_ACCUM, tr.lora)
    t = fence()
    updates, tr.opt_state = tr.tx.update(avg, tr.opt_state, tr.lora)
    apply_updates(tr.lora, updates)
    split["optimizer"] = fence() - t
    total = sum(split.values())
    print("train step split (fenced): " + ", ".join(
        f"{k} {v * 1e3:.1f} ms ({v / total:.0%})" for k, v in split.items())
        + f" = {total * 1e3:.1f} ms")
    if profile:
        from torch.profiler import ProfilerActivity
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            tr.train_step(micro)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        print_profile("train step", prof, wall_ms, 1, top_k=8)
    del tr, micro, avg, updates

    # Kernel path vs plain path (and the plain path in fp32) on one
    # microbatch, a bank with B != 0 and no dropout.
    bank = tree_map(lambda x: x, bank)
    for side in bank.values():
        for e in side.values():
            e["b"] = torch.randn(e["b"].shape, generator=g, device=device) * LORA_B_STD
    lcfg0 = lora_lib.LoraConfig(r=LORA_RANK, alpha=LORA_ALPHA, dropout=0.0,
                                target_modules=lcfg.target_modules)
    batch0 = next(iter(train_loader.one_epoch()))
    params32 = tree_map(lambda x: x.float(), params)
    res = {}
    for name, base, kw in (("kernel", params, dict(flash_attention="on")),
                           ("plain", params, dict(flash_attention="off")),
                           ("plain fp32", params32, dict(flash_attention="off",
                                                         mixed_precision="no"))):
        t = ASRTrainer(cfg, base, bank, lcfg0, TrainingArgs(**targs, **kw))
        loss, grads = t.lora_grads(batch0, None)
        res[name] = (float(loss), [x.float() for x in leaves(grads)])
        del t
    del params32

    def compare(a, b):
        la, ga = res[a]
        lb, gb = res[b]
        cos = [float(torch.nn.functional.cosine_similarity(x.flatten(), y.flatten(), dim=0))
               for x, y in zip(ga, gb)]
        dn = [abs(float(x.norm() - y.norm())) / float(y.norm()) for x, y in zip(ga, gb)]
        return abs(la - lb) / abs(lb), min(cos), max(dn)
    kp, k32, p32 = compare("kernel", "plain"), compare("kernel", "plain fp32"), \
        compare("plain", "plain fp32")
    print(f"train kernel vs plain path (one microbatch of {batch}, B ~ N(0, {LORA_B_STD}), "
          f"dropout 0): loss {res['kernel'][0]:.6f} vs {res['plain'][0]:.6f}, rel err "
          f"{kp[0]:.3e} (tol {TRAIN_LOSS_REL_TOL}) | {len(res['kernel'][1])} LoRA leaves: min "
          f"cosine {kp[1]:.6f} (need >= {TRAIN_GRAD_MIN_COS}), max rel norm diff {kp[2]:.3e} "
          f"(tol {TRAIN_GRAD_NORM_REL_TOL}) | against the fp32 plain path: kernel rel "
          f"{k32[0]:.3e} cos {k32[1]:.6f} norm {k32[2]:.3e}; bf16 plain rel {p32[0]:.3e} cos "
          f"{p32[1]:.6f} norm {p32[2]:.3e}")
    if kp[0] > TRAIN_LOSS_REL_TOL or kp[1] < TRAIN_GRAD_MIN_COS or kp[2] > TRAIN_GRAD_NORM_REL_TOL:
        fail("the train kernel path disagrees with the plain path")
    return counts


def _kv_errors(name, got, want, t_valid):
    """K2's rules for the (kq, ks, vq, vs) of K2 or K4 against the plain
    version: int8 |d| <= 1 on <= KV_FLIP_FRAC_TOL of entries, scales within
    KV_SCALE_REL_TOL, pad rows 0 with scale 0. Returns (flip fraction,
    scale max rel err, dequantized max abs err)."""
    flip, deq_err, scale_err = 0.0, 0.0, 0.0
    L, B, S_pad, D = got[0].shape
    H = got[1].shape[2]
    deq = lambda q8, s: q8.float().reshape(L, B, S_pad, H, D // H) * s.transpose(2, 3)[..., None]
    for gq, gs, wq, ws in ((got[0], got[1], want[0], want[1]),
                           (got[2], got[3], want[2], want[3])):
        dq = (gq.int() - wq.int()).abs()
        if dq.max().item() > 1:
            fail(f"{name} int8 values differ by {dq.max().item()} (> 1)")
        flip = max(flip, (dq != 0).float().mean().item())
        if gq[:, :, t_valid:].any() or gs[..., t_valid:].any():
            fail(f"{name} pad rows are not 0 with scale 0")
        scale_err = max(scale_err, ((gs[..., :t_valid] - ws[..., :t_valid]).abs()
                                    / ws[..., :t_valid]).max().item())
        deq_err = max(deq_err, (deq(gq, gs) - deq(wq, ws)).abs().max().item())
    if flip > KV_FLIP_FRAC_TOL or scale_err > KV_SCALE_REL_TOL:
        fail(f"{name} disagrees with its plain version")
    return flip, scale_err, deq_err


def decode_steps(tokens, cfg, prompt_len: int) -> int:
    """decode_step calls the greedy loop made: it stops once every row has
    emitted EOS after the prompt, or at total - 1."""
    total = tokens.shape[1]
    gen = tokens[:, prompt_len:] == cfg.eos_token_id
    if not bool(gen.any(1).all()):
        return total - 1
    first = gen.int().argmax(1) + prompt_len
    return min(int(first.max()), total - 1)


K6_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
K7_NAMES = ("cross_decode_attention", "cross_decode_attention_beam")
# K8 runs on the fq path only; K9 and K10 have no caller in either package
# (checked and timed in phase_kernels_k8_k10, launched on no path).
OFF_PATH = ("encoder_attention_fused", "self_decode_attention", "decode_attention")
KERNEL_NAMES = ("encoder_attention_hm", "fused_kv_init", "fused_kv_init_lora",
                "cross_decode_attention_exact", "cross_decode_attention_exact_beam",
                *K6_NAMES, *K7_NAMES, *OFF_PATH)
INT8 = dict(cross_kv_int8=True, self_kv_int8=True)   # the int8 head-minor cache


def reset_counts():
    from sar_tpu_torch.ops import decode_cross, flash, flash_enc, kv_init
    from sar_tpu_torch.ops.attic import attention, decode_self
    flash_enc.LAUNCHES = flash_enc.FUSED_LAUNCHES = 0
    kv_init.LAUNCHES = kv_init.LORA_LAUNCHES = 0
    decode_cross.LAUNCHES = decode_cross.BEAM_LAUNCHES = 0
    decode_cross.S8_LAUNCHES = decode_cross.S8_BEAM_LAUNCHES = 0
    flash.LAUNCHES = flash.DQ_LAUNCHES = flash.DKV_LAUNCHES = 0
    decode_self.LAUNCHES = attention.LAUNCHES = 0


def read_counts() -> dict:
    from sar_tpu_torch.ops import decode_cross, flash, flash_enc, kv_init
    from sar_tpu_torch.ops.attic import attention, decode_self
    return dict(zip(KERNEL_NAMES, (flash_enc.LAUNCHES, kv_init.LAUNCHES,
                                   kv_init.LORA_LAUNCHES, decode_cross.LAUNCHES,
                                   decode_cross.BEAM_LAUNCHES, flash.LAUNCHES,
                                   flash.DQ_LAUNCHES, flash.DKV_LAUNCHES,
                                   decode_cross.S8_LAUNCHES,
                                   decode_cross.S8_BEAM_LAUNCHES,
                                   flash_enc.FUSED_LAUNCHES, decode_self.LAUNCHES,
                                   attention.LAUNCHES)))


def check_counts(path: str, counts: dict, want_zero: tuple) -> None:
    """Every kernel of the path launched, and none that is not on it."""
    missing = [k for k in KERNEL_NAMES if k not in want_zero and counts[k] == 0]
    if missing:
        fail(f"the {path} path launched no {', '.join(missing)} kernel")
    extra = [k for k in want_zero if counts[k] != 0]
    if extra:
        fail(f"the {path} path launched {', '.join(extra)}, which is not on it")


def make_model(cfg, device):
    """Random bf16 weights of the model (seeded) on the card."""
    import torch
    from sar_tpu_torch.models import whisper
    g = torch.Generator(device=device).manual_seed(SEED)
    params = whisper.init_params(cfg, g, device)
    n_params = whisper.param_count(params)
    return whisper.cast_params(params, torch.bfloat16), n_params


def phase_e2e(cfg, params, n_params, device, batch, n_batches, max_new_tokens,
              language="hindi"):
    import torch
    from sar_tpu_torch.evaluation import ASREvaluator
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.ops import mel as mel_ops

    g = torch.Generator(device=device).manual_seed(SEED + 1)
    t0 = time.perf_counter()
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
    reset_counts()
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
    counts = read_counts()
    audio_s = n_batches * batch * mel_ops.CHUNK_SECONDS
    ms_tok = 1e3 * sum(o[2] for o in outs) / sum(o[1] for o in outs)
    print(f"e2e: {audio_s} audio-s in {wall:.3f} s -> RTFx {audio_s / wall:.1f} | "
          f"{ms_tok:.3f} ms/token-step (batch {batch}) | launches {json.dumps(counts)}")
    check_counts("greedy", counts, want_zero=("fused_kv_init_lora",
                                              "cross_decode_attention_exact_beam", *K6_NAMES,
                                              *K7_NAMES, *OFF_PATH))

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


def phase_routed(cfg, params, device, batch, max_new_tokens, profile=False):
    """The routed serving path at full width: LID -> per-row adapters ->
    K4 cache -> routed greedy, through TranscriptionService and
    AdapterRouter; returns the launch counts of its run."""
    import threading

    import numpy as np
    import torch
    from sar_tpu_torch.models import classifier as clf
    from sar_tpu_torch.models import lora as lora_lib
    from sar_tpu_torch.models.config import TARGET_LANGUAGES
    from sar_tpu_torch.models.router import AdapterRouter
    from sar_tpu_torch.ops import mel as mel_ops
    from sar_tpu_torch.serving import TranscriptionService

    g = torch.Generator(device=device).manual_seed(SEED + 2)
    lcfg = lora_lib.LoraConfig(r=LORA_RANK, alpha=LORA_ALPHA, dropout=0.0,
                               target_modules=("q_proj", "v_proj"))
    bank = lora_lib.init_lora(g, cfg, lcfg, num_adapters=len(TARGET_LANGUAGES))
    bank = lora_lib.map_with_path(
        lambda path, x: (torch.randn(x.shape, generator=g, device=device) * LORA_B_STD
                         if path[-1] == "b" else x), bank)
    ccfg = clf.ClassifierConfig(input_dim=cfg.d_model, hidden_dims=(256, 128),
                                num_classes=len(TARGET_LANGUAGES), pooling="mean",
                                languages=tuple(TARGET_LANGUAGES), encoder_layer=LID_LAYER)
    router = AdapterRouter(cfg, params, bank, lcfg, clf.init_classifier(g, ccfg), ccfg,
                           device=device)
    if router.flash != "hm" or not router.kernels:
        fail(f"the router did not pick the kernels (flash={router.flash!r})")
    rng = np.random.default_rng(SEED)
    clip_len = cfg.num_audio_frames * mel_ops.HOP_LENGTH     # the 30 s window
    clips = [(rng.standard_normal(clip_len) * 0.1).astype(np.float32)
             for _ in range(ROUTED_REQUESTS)]
    idx = torch.tensor(MIXED_ADAPTERS[:batch], device=device)

    def features(chunk):
        audio = torch.from_numpy(mel_ops.stack_pad_audio(chunk)).to(device)
        return mel_ops.log_mel_spectrogram(audio, cfg.num_mel_bins, dtype=torch.bfloat16)[
            :, :, :cfg.num_audio_frames]

    feats = features(clips[:batch])
    router.decode(router.encode(feats, idx), idx, max_new_tokens)  # warm-up
    torch.cuda.synchronize()

    reset_counts()
    svc = TranscriptionService(router=router, batch_size=batch, max_wait_ms=50.0,
                               max_new_tokens=max_new_tokens)
    results = [None] * ROUTED_REQUESTS

    def client(k):
        mine = range(k, ROUTED_REQUESTS, ROUTED_THREADS)
        try:
            handles = [(i, svc.submit(clips[i])) for i in mine]
            for i, h in handles:
                results[i] = h.result(timeout=600.0)
        except BaseException as e:       # noqa: BLE001 — fails the phase below
            for i in mine:
                results[i] = results[i] if isinstance(results[i], list) else e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(ROUTED_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    svc.close()
    st = svc.stats()
    errors = [r for r in results if not isinstance(r, list)]
    if errors or st["errors"] > 0 or st["rows_served"] != ROUTED_REQUESTS:
        fail(f"routed service: {len(errors)} requests failed ({errors[:1]}), "
             f"stats {st}")
    if any(len(r) > max_new_tokens or any(not 0 <= tok < cfg.vocab_size for tok in r)
           for r in results):
        fail("routed service returned a bad token list")
    audio_s = ROUTED_REQUESTS * clip_len / mel_ops.SAMPLE_RATE
    print(f"routed service: {ROUTED_REQUESTS} requests x 30 s from {ROUTED_THREADS} threads,"
          f" batches of {batch}, {st['batches']} batches: {audio_s} audio-s in {wall:.3f} s"
          f" -> routed RTFx {audio_s / wall:.1f} | latency p50 {st['latency_ms_p50']:.1f} ms"
          f" p95 {st['latency_ms_p95']:.1f} ms | errors {st['errors']}")

    # The mixed batch (a random LID head may send every row to one adapter),
    # its phases fenced.
    def fenced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    enc, t_enc = fenced(lambda: router.encode(feats, idx))
    cache, t_cache = fenced(lambda: router.cache(enc, idx, max_new_tokens))
    tok_k, t_dec = fenced(lambda: router.decode_from_cache(cache, idx))
    del enc, cache
    steps = decode_steps(tok_k, cfg, router.prompt_len)
    counts = read_counts()
    if tok_k.shape != (batch, router.prompt_len + max_new_tokens) or tok_k.min() < 0 \
            or tok_k.max() >= cfg.vocab_size:
        fail(f"routed generate: bad token tensor {tuple(tok_k.shape)}")
    print(f"routed generate, adapters {MIXED_ADAPTERS[:batch]}: adapted encode "
          f"{t_enc * 1e3:.1f} ms, cache (K4) {t_cache * 1e3:.1f} ms, decode "
          f"{t_dec * 1e3:.1f} ms for {steps} steps = {t_dec * 1e3 / steps:.3f} "
          f"ms/token-step at batch {batch}")
    print(f"routed launches {json.dumps(counts)}")
    check_counts("routed", counts, want_zero=("fused_kv_init",
                                              "cross_decode_attention_exact_beam", *K6_NAMES,
                                              *K7_NAMES, *OFF_PATH))

    # LID overhead: tap (the first LID_LAYER + 1 encoder layers) + head.
    def lid():
        router.detect_language(router.extract_encoder_features(feats))
    lid_ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lid()
        torch.cuda.synchronize()
        lid_ms.append((time.perf_counter() - t0) * 1e3)
    lid_ms = statistics.median(lid_ms[1:])
    print(f"LID overhead: {lid_ms:.2f} ms per batch of {batch} = {lid_ms / batch:.3f} "
          f"ms per utterance (layer {LID_LAYER} tap + head; the reference's target < 10 ms)")

    # Lockstep against the routed plain path, both fed the kernel path's
    # tokens; then the plain path free-running.
    plain = AdapterRouter(cfg, params, bank, lcfg, router.clf_params, ccfg,
                          device=device, flash=False, kernels=False)
    cache_k = router.cache(router.encode(feats, idx), idx, max_new_tokens)
    cache_p = plain.cache(plain.encode(feats, idx), idx, max_new_tokens)
    P = router.prompt_len
    agree, n, max_dlogit = 0, 0, 0.0
    for pos in range(steps):
        lk, cache_k = router.step(tok_k[:, pos], pos, cache_k, idx)
        lp, cache_p = plain.step(tok_k[:, pos], pos, cache_p, idx)
        if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
            fail(f"routed: non-finite logits at step {pos}")
        if pos + 1 >= P:
            agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
            n += batch
            max_dlogit = max(max_dlogit, (lk - lp).abs().max().item())
    tok_p = plain.decode(plain.encode(feats, idx), idx, max_new_tokens)
    free = (tok_k[:, P:] == tok_p[:, P:]).float().mean().item()
    lock = agree / max(n, 1)
    print(f"routed vs plain routed path: lockstep argmax agreement {lock:.4f} "
          f"({agree}/{n} row-steps, need >= {LOCKSTEP_MIN_AGREEMENT}) | max |dlogit| "
          f"{max_dlogit:.4e} | free-running token agreement {free:.4f}")
    if lock < LOCKSTEP_MIN_AGREEMENT:
        fail("the routed kernel path disagrees with the routed plain path")
    if profile:
        from sar_tpu_torch.models import whisper
        P = router.prompt_len
        cache_g = whisper.init_cache(params, router.encode(feats, idx), cfg, P + max_new_tokens,
                                     **INT8)
        cache_r = router.cache(router.encode(feats, idx), idx, max_new_tokens)
        for name, step, cache in (
                ("greedy", lambda tok, pos, c: whisper.decode_step(params, tok, pos, c, cfg),
                 cache_g),
                ("routed", lambda tok, pos, c: router.step(tok, pos, c, idx), cache_r)):
            profile_steps(name, step, cache, tok_k, P)
    return counts


def phase_beam(cfg, params, device, batch, max_new_tokens, profile=False):
    """The evaluation workload with beams at full width: synthetic items ->
    DataLoader + collator -> ASREvaluator(num_beams=BEAM_WIDTH).evaluate
    (encoder K1 -> beam_decode: cache K2, every cross-attention K5) ->
    corpus WER/CER; then the first batch through the plain path in lockstep
    and free running. Returns the launch counts of the evaluate run."""
    import numpy as np
    import torch
    from sar_tpu_torch.data import (CharTokenizer, DataLoader, SyntheticASRDataset,
                                    create_collator)
    from sar_tpu_torch.decode import beam as beam_lib
    from sar_tpu_torch.evaluation import ASREvaluator
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.ops import mel as mel_ops

    K = BEAM_WIDTH
    t0 = time.perf_counter()
    ds = SyntheticASRDataset(cfg, size=BEAM_ITEMS, language="english", seed=SEED)
    loader = DataLoader(ds, batch, create_collator(cfg.sot_token_id, num_mels=cfg.num_mel_bins,
                                                   num_frames=cfg.num_audio_frames,
                                                   device=device),
                        shuffle=False, drop_last=False)
    ev = ASREvaluator(cfg, params, CharTokenizer(cfg), language="english",
                      max_new_tokens=max_new_tokens, num_beams=K, device=device)
    if ev.flash != "hm" or not ev.kernels:
        fail(f"the beam evaluator did not pick the kernels (flash={ev.flash!r})")
    first = next(iter(loader.one_epoch()))
    feats = torch.as_tensor(first["input_features"]).to(device, torch.bfloat16)
    P = int(ev._prompt.shape[0])
    print(f"beam setup: {BEAM_ITEMS} synthetic {cfg.name} items, batches of {batch}, "
          f"K={K}, {time.perf_counter() - t0:.1f} s")
    ev.tokens(feats)                                   # warm-up batch, not counted
    torch.cuda.synchronize()

    steps = [0]
    real_step = whisper.decode_step

    def counting_step(*a, **k):
        steps[0] += 1
        return real_step(*a, **k)

    reset_counts()
    whisper.decode_step = counting_step
    try:
        t0 = time.perf_counter()
        res = ev.evaluate(loader, return_predictions=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        whisper.decode_step = real_step
    counts = read_counts()
    if res["num_samples"] != BEAM_ITEMS or not all(
            np.isfinite(res[m]) and res[m] >= 0 for m in ("wer", "cer")):
        fail(f"beam evaluate: bad result {({k: res[k] for k in ('wer', 'cer', 'num_samples')})}")
    audio_s = BEAM_ITEMS * mel_ops.CHUNK_SECONDS         # one 30 s window per item
    print(f"beam evaluate: WER {res['wer']:.4f} CER {res['cer']:.4f} over "
          f"{res['num_samples']} items (random weights: the path, not the accuracy) | "
          f"{audio_s:.0f} audio-s in {wall:.3f} s -> RTFx {audio_s / wall:.1f} | "
          f"{steps[0]} decode steps | launches {json.dumps(counts)}")
    check_counts("beam", counts, want_zero=("fused_kv_init_lora",
                                            "cross_decode_attention_exact", *K6_NAMES,
                                            *K7_NAMES, *OFF_PATH))
    if counts["cross_decode_attention_exact_beam"] != steps[0] * cfg.decoder_layers:
        fail("K5 was not launched once per layer of every beam decode step")

    # The first batch fenced: encoder, then beam_decode (cache + loop).
    def fenced(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    enc, t_enc = fenced(lambda: ev.encode(feats))
    steps[0] = 0
    whisper.decode_step = counting_step
    try:
        tok_k, t_dec = fenced(lambda: ev.beam(feats))
    finally:
        whisper.decode_step = real_step
    n_steps = steps[0]
    if tok_k.shape != (batch, ev.total) or tok_k.min() < 0 or tok_k.max() >= cfg.vocab_size:
        fail(f"beam decode: bad token tensor {tuple(tok_k.shape)}")
    print(f"beam batch 0: encode {t_enc * 1e3:.1f} ms, beam decode (cache + loop) "
          f"{t_dec * 1e3:.1f} ms for {n_steps} steps = {t_dec * 1e3 / n_steps:.3f} "
          f"ms/token-step at {batch} samples x {K} beams")

    # Lockstep: the kernel path, the plain path and the plain path's twin
    # with fp64 sums in the cross-attention (same rounding points) decode
    # from one beam state (tokens and ancestry), which the kernel path's
    # selection advances. The twin measures the noise floor: how often two
    # correct implementations that differ only in summation order pick
    # different argmaxes on beam rows (near ties of a random model).
    plain = ASREvaluator(cfg, params, CharTokenizer(cfg), language="english",
                         max_new_tokens=max_new_tokens, num_beams=K, device=device,
                         flash=False, kernels=False)
    total = ev.total
    prompt = ev._prompt[None].expand(batch, -1)
    cache_k = whisper.init_cache(params, enc, cfg, total, self_batch=batch * K, **INT8)
    cache_p = whisper.init_cache(params, plain.encode(feats), cfg, total,
                                 self_batch=batch * K, kernels=False, **INT8)
    cache_t = cache_p._replace(**{f: getattr(cache_p, f).clone() for f in (
        "self_k", "self_v", "self_k_scale", "self_v_scale")})
    state = beam_lib.init_state(prompt, K, total, cfg.eos_token_id)
    slots = torch.arange(K, device=device)
    n = strict = near = best = twin = 0
    flips_by_rank, max_dlogit = [0] * K, 0.0
    plain_cross = whisper.cross_decode_reference_exact
    with torch.no_grad():
        for pos in range(total - 1):
            if not bool(state.unsat.any()):
                break
            state.anc[:, :, pos] = slots
            tok = state.run_seqs.reshape(batch * K, total)[:, pos]
            lk, cache_k = whisper.decode_step(params, tok, pos, cache_k, cfg, beam_width=K,
                                              ancestry=state.anc)
            lp, cache_p = whisper.decode_step(params, tok, pos, cache_p, cfg, beam_width=K,
                                              ancestry=state.anc, kernels=False)
            whisper.cross_decode_reference_exact = _cross_reference_fp64
            try:
                lt, cache_t = whisper.decode_step(params, tok, pos, cache_t, cfg, beam_width=K,
                                                  ancestry=state.anc, kernels=False)
            finally:
                whisper.cross_decode_reference_exact = plain_cross
            if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
                fail(f"beam: non-finite logits at step {pos}")
            if pos + 1 >= P:
                same, near_ok = lockstep_rows(lk, lp)
                n += batch * K
                strict += int(same.sum())
                near += int(near_ok.sum())
                best += int(same.reshape(batch, K)[:, 0].sum())
                twin += int((lt.argmax(-1) == lp.argmax(-1)).sum())
                for r in torch.nonzero(~same).flatten().tolist():
                    flips_by_rank[r % K] += 1
                max_dlogit = max(max_dlogit, (lk - lp).abs().max().item())
            state = beam_lib.beam_select(state, lk, pos, P, eos=cfg.eos_token_id)
    replayed = torch.equal(state.fin_seqs[:, 0], tok_k)
    tok_p = plain.tokens(feats)
    free = (tok_k[:, P:] == tok_p[:, P:]).float().mean().item()
    n = max(n, 1)
    lock_best, lock_near = best / (n // K), near / n
    print(f"beam vs plain path (batch 0, K={K}): lockstep argmax agreement {strict / n:.4f} "
          f"({strict}/{n} row-steps; flips by beam rank {flips_by_rank}) against a noise "
          f"floor of {twin / n:.4f} (plain vs its fp64-sum twin) | best beam's rows "
          f"{lock_best:.4f} ({best}/{n // K}) and up to near ties (gap <= {LOGIT_TIE_TOL}) "
          f"{lock_near:.4f}, each need >= {LOCKSTEP_MIN_AGREEMENT} | max |dlogit| "
          f"{max_dlogit:.4e} | free-running token agreement {free:.4f} | the lockstep "
          f"search {'reproduced' if replayed else 'did NOT reproduce'} the kernel path's tokens")
    if lock_best < LOCKSTEP_MIN_AGREEMENT or lock_near < LOCKSTEP_MIN_AGREEMENT:
        fail("the beam kernel path disagrees with the beam plain path")
    if profile:
        holder = {"state": beam_lib.init_state(prompt, K, total, cfg.eos_token_id)}

        def beam_step(_tokens, pos, cache):
            st = holder["state"]
            st.anc[:, :, pos] = slots
            logits, cache = whisper.decode_step(
                params, st.run_seqs.reshape(batch * K, total)[:, pos], pos, cache, cfg,
                beam_width=K, ancestry=st.anc)
            holder["state"] = beam_lib.beam_select(st, logits, pos, P, eos=cfg.eos_token_id)
            return logits, cache

        cache_b = whisper.init_cache(params, enc, cfg, total, self_batch=batch * K, **INT8)
        for pos in range(P):                           # the prompt, unprofiled
            _, cache_b = beam_step(None, pos, cache_b)
        profile_steps("beam", beam_step, cache_b, tok_k, P)
    return counts


def lockstep_rows(lk, lp):
    """Per row of two paths' logits [rows, V] fed the same tokens: argmax
    equal, and equal up to a near tie (the top-2 gap at most LOGIT_TIE_TOL
    in both paths' own logits)."""
    tk, tp = lk.argmax(-1), lp.argmax(-1)
    same = tk == tp
    gap_k = lk.gather(1, tk[:, None]) - lk.gather(1, tp[:, None])
    gap_p = lp.gather(1, tp[:, None]) - lp.gather(1, tk[:, None])
    return same, same | ((gap_k[:, 0] <= LOGIT_TIE_TOL) & (gap_p[:, 0] <= LOGIT_TIE_TOL))


def phase_s8(cfg, params, device, batch, n_batches, max_new_tokens, profile=False):
    """The opt-in quantized decode at full width through ASREvaluator: the
    greedy cell's clips with scores_int8 (K7, q [B, D]), one batch of beams
    with scores_int8 (K7 beam-folded, the self cache reordered physically),
    each counted and held against its plain path in lockstep; the gate's
    readings against the exact path; one greedy batch over the int4 cache.
    Returns the launch counts of the counted runs, summed."""
    import torch
    from sar_tpu_torch.decode import beam as beam_lib
    from sar_tpu_torch.evaluation import ASREvaluator
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.ops import mel as mel_ops

    g = torch.Generator(device=device).manual_seed(SEED + 1)      # the greedy cell's clips
    audio = [torch.randn((batch, mel_ops.N_SAMPLES), generator=g, device=device) * 0.1
             for _ in range(n_batches)]
    L, K = cfg.decoder_layers, BEAM_WIDTH
    kw = dict(language="hindi", max_new_tokens=max_new_tokens, device=device)
    ev = ASREvaluator(cfg, params, scores_int8=True, **kw)
    if ev.flash != "hm" or not ev.kernels or not ev.scores_int8:
        fail(f"the s8 evaluator did not pick the kernels (flash={ev.flash!r})")
    P = int(ev._prompt.shape[0])
    steps = [0]
    real_step = whisper.decode_step

    def counting_step(*a, **k):
        steps[0] += 1
        return real_step(*a, **k)

    def counted(fn):
        """fn() with the launch counters zeroed before and read after and
        its decode steps counted: (out, counts, steps, wall seconds)."""
        torch.cuda.synchronize()
        reset_counts()
        steps[0] = 0
        whisper.decode_step = counting_step
        try:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            whisper.decode_step = real_step
        return out, read_counts(), steps[0], wall

    def mel(a):
        return mel_ops.log_mel_spectrogram(a, cfg.num_mel_bins,
                                           dtype=torch.bfloat16)[:, :, :cfg.num_audio_frames]

    def greedy(evaluator, clips):
        """mel -> prep -> dec per batch: [(tokens, fenced decode seconds)]."""
        out = []
        for a in clips:
            cache = evaluator.prep(mel(a))
            torch.cuda.synchronize()
            t = time.perf_counter()
            tokens = evaluator.dec(cache)
            torch.cuda.synchronize()
            out.append((tokens, time.perf_counter() - t))
        return out

    def check_tokens(label, tokens, total):
        if tokens.shape != (batch, total) or tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
            fail(f"{label}: bad token tensor {tuple(tokens.shape)}")

    others = [k for k in KERNEL_NAMES if k not in ("encoder_attention_hm", "fused_kv_init")]
    greedy(ev, audio[:1])                                          # warm-up, not counted
    outs, c_greedy, n_steps, wall = counted(lambda: greedy(ev, audio))
    for i, (tokens, _) in enumerate(outs):
        check_tokens(f"s8 greedy batch {i}", tokens, ev.total)
    audio_s = n_batches * batch * mel_ops.CHUNK_SECONDS
    ms_tok = 1e3 * sum(t for _, t in outs) / n_steps
    print(f"s8 greedy: {audio_s} audio-s in {wall:.3f} s -> RTFx {audio_s / wall:.1f} | "
          f"{ms_tok:.3f} ms/token-step (batch {batch}, {n_steps} decode steps) | launches "
          f"{json.dumps(c_greedy)}")
    check_counts("s8 greedy", c_greedy,
                 want_zero=tuple(k for k in others if k != "cross_decode_attention"))
    if c_greedy["cross_decode_attention"] != L * n_steps:
        fail(f"s8 greedy: K7 launched {c_greedy['cross_decode_attention']} times in "
             f"{n_steps} decode steps, not {L} per step")

    # Lockstep against the plain path (kernels=False, exact encoder), both
    # fed the kernel path's tokens; then the gate's readings against the
    # exact-scores path on the same batch.
    plain = ASREvaluator(cfg, params, scores_int8=True, flash=False, kernels=False, **kw)
    exact = ASREvaluator(cfg, params, **kw)
    tok_k = outs[0][0]
    f0 = mel(audio[0])
    lock_steps = decode_steps(tok_k, cfg, P)
    cache_k, cache_p = ev.prep(f0), plain.prep(f0)
    agree, n, max_dlogit = 0, 0, 0.0
    with torch.no_grad():
        for pos in range(lock_steps):
            lk, cache_k = whisper.decode_step(params, tok_k[:, pos], pos, cache_k, cfg,
                                              scores_int8=True)
            lp, cache_p = whisper.decode_step(params, tok_k[:, pos], pos, cache_p, cfg,
                                              scores_int8=True, kernels=False)
            if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
                fail(f"s8: non-finite logits at step {pos}")
            if pos + 1 >= P:
                agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
                n += batch
                max_dlogit = max(max_dlogit, (lk - lp).abs().max().item())
        tok_x = exact.dec(exact.prep(f0))
        cache_s, cache_x = ev.prep(f0), exact.prep(f0)
        gate_dlogit = 0.0
        for pos in range(min(4, P)):                   # the gate's probe: forced prompt steps
            tok = ev._prompt[pos].expand(batch)
            ls, cache_s = whisper.decode_step(params, tok, pos, cache_s, cfg, scores_int8=True)
            lx, cache_x = whisper.decode_step(params, tok, pos, cache_x, cfg)
            gate_dlogit = max(gate_dlogit, (ls - lx).abs().max().item())
    lock = agree / max(n, 1)
    rows_equal = (tok_k == tok_x).all(1).float().mean().item()
    tok_equal = (tok_k[:, P:] == tok_x[:, P:]).float().mean().item()
    print(f"s8 greedy vs plain path (batch 0): lockstep argmax agreement {lock:.4f} "
          f"({agree}/{n} row-steps, need >= {LOCKSTEP_MIN_AGREEMENT}) | max |dlogit| "
          f"{max_dlogit:.4e} | gate readings against exact scores (not enforced): rows "
          f"equal {rows_equal:.4f}, tokens equal {tok_equal:.4f}, max |dlogit| over the "
          f"{min(4, P)} forced prompt steps {gate_dlogit:.4e}")
    if lock < LOCKSTEP_MIN_AGREEMENT:
        fail("the s8 kernel path disagrees with the s8 plain path")
    if profile:
        step = lambda tok, pos, c: whisper.decode_step(params, tok, pos, c, cfg, scores_int8=True)
        profile_steps("s8 greedy", step, ev.prep(f0), tok_k, P)

    # Beams: one batch of `batch` samples x K beams, K7 beam-folded.
    ev_b = ASREvaluator(cfg, params, scores_int8=True, num_beams=K, **kw)
    tok_b, c_beam, n_beam, wall_b = counted(lambda: ev_b.tokens(f0))
    check_tokens("s8 beam", tok_b, ev_b.total)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = ev_b.encode(f0)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    print(f"s8 beam (batch 0, {batch} samples x {K} beams): {batch * mel_ops.CHUNK_SECONDS} "
          f"audio-s in {wall_b:.3f} s -> RTFx {batch * mel_ops.CHUNK_SECONDS / wall_b:.1f} | "
          f"{1e3 * (wall_b - t_enc) / n_beam:.3f} ms/token-step over {n_beam} steps (cache + "
          f"loop: the wall less a fenced encode of {t_enc * 1e3:.1f} ms) | launches "
          f"{json.dumps(c_beam)}")
    check_counts("s8 beam", c_beam,
                 want_zero=tuple(k for k in others if k != "cross_decode_attention_beam"))
    if c_beam["cross_decode_attention_beam"] != L * n_beam:
        fail(f"s8 beam: K7 launched {c_beam['cross_decode_attention_beam']} times in "
             f"{n_beam} decode steps, not {L} per step")

    # Beam lockstep: kernel and plain paths decode from one beam state,
    # which the kernel path's selection advances, each reordering its own
    # self cache by it.
    total = ev_b.total
    prompt = ev_b._prompt[None].expand(batch, -1)
    plain_b = ASREvaluator(cfg, params, scores_int8=True, num_beams=K, flash=False,
                           kernels=False, **kw)
    cache_k = whisper.init_cache(params, enc, cfg, total, self_batch=batch * K, **INT8)
    cache_p = whisper.init_cache(params, plain_b.encode(f0), cfg, total,
                                 self_batch=batch * K, kernels=False, **INT8)
    state = beam_lib.init_state(prompt, K, total, cfg.eos_token_id)
    slots = torch.arange(K, device=device)
    n = strict = near = best = 0
    with torch.no_grad():
        for pos in range(total - 1):
            if not bool(state.unsat.any()):
                break
            state.anc[:, :, pos] = slots
            tok = state.run_seqs.reshape(batch * K, total)[:, pos]
            lk, cache_k = whisper.decode_step(params, tok, pos, cache_k, cfg, scores_int8=True,
                                              beam_width=K)
            lp, cache_p = whisper.decode_step(params, tok, pos, cache_p, cfg, scores_int8=True,
                                              beam_width=K, kernels=False)
            if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
                fail(f"s8 beam: non-finite logits at step {pos}")
            if pos + 1 >= P:
                same, near_ok = lockstep_rows(lk, lp)
                n += batch * K
                strict += int(same.sum())
                near += int(near_ok.sum())
                best += int(same.reshape(batch, K)[:, 0].sum())
            state = beam_lib.beam_select(state, lk, pos, P, eos=cfg.eos_token_id)
            if pos + 1 >= P:
                cache_k = beam_lib.reorder_self_cache(cache_k, state.anc[:, :, pos])
                cache_p = beam_lib.reorder_self_cache(cache_p, state.anc[:, :, pos])
    replayed = torch.equal(state.fin_seqs[:, 0], tok_b)
    n = max(n, 1)
    lock_best, lock_near = best / (n // K), near / n
    print(f"s8 beam vs plain path (batch 0, K={K}): lockstep argmax agreement {strict / n:.4f} "
          f"({strict}/{n} row-steps) | best beam's rows {lock_best:.4f} ({best}/{n // K}) and "
          f"up to near ties (gap <= {LOGIT_TIE_TOL}) {lock_near:.4f}, each need >= "
          f"{LOCKSTEP_MIN_AGREEMENT} | the lockstep search "
          f"{'reproduced' if replayed else 'did NOT reproduce'} the kernel path's tokens")
    if lock_best < LOCKSTEP_MIN_AGREEMENT or lock_near < LOCKSTEP_MIN_AGREEMENT:
        fail("the s8 beam kernel path disagrees with the s8 beam plain path")
    del cache_k, cache_p, state

    # int4: one greedy batch over the nibble-packed cache (plain torch; the
    # encoder is K1's), against the exact int8 path's tokens.
    ev4 = ASREvaluator(cfg, params, kv_int4=True, **kw)
    out4, c_int4, n4, _ = counted(lambda: greedy(ev4, audio[:1]))
    tok4, t4 = out4[0]
    check_tokens("int4 greedy", tok4, ev4.total)
    check_counts("int4 greedy", c_int4, want_zero=(*others, "fused_kv_init"))
    print(f"int4 greedy (batch 0): {1e3 * t4 / n4:.3f} ms/token-step over {n4} steps | "
          f"against the exact int8 path: rows equal "
          f"{(tok4 == tok_x).all(1).float().mean().item():.4f}, tokens equal "
          f"{(tok4[:, P:] == tok_x[:, P:]).float().mean().item():.4f} | launches "
          f"{json.dumps(c_int4)}")
    return {k: c_greedy[k] + c_beam[k] + c_int4[k] for k in KERNEL_NAMES}


def _cross_reference_fp64(q, kq, ks, vq, vs, *, layer, n_heads, out_dtype=None):
    """The plain beam-folded cross-attention with its sums in fp64 and the
    same rounding points (pw and the output in q's dtype): the lockstep's
    noise-floor twin."""
    import torch
    kq, ks, vq, vs = kq[layer], ks[layer], vq[layer], vs[layer]
    B, K, D = q.shape
    H, S = n_heads, kq.shape[1]
    hd = D // H
    st = torch.einsum("bkhd,bshd->bkhs", q.reshape(B, K, H, hd).double(),
                      kq.reshape(B, S, H, hd).double()) * ks[:, None].double()
    p = torch.softmax(torch.where(ks[:, None] > 0, st, -1e30), dim=-1)
    pw = (p * vs[:, None].double()).float().to(q.dtype).double()
    o = torch.einsum("bkhs,bshd->bkhd", pw, vq.reshape(B, S, H, hd).double())
    return o.reshape(B, K, D).float().to(out_dtype or q.dtype)


def profile_steps(name, step, cache, tokens, first_pos):
    """PROFILE_STEPS decode steps from `first_pos` (after PROFILE_STEPS
    untimed ones) under torch.profiler: wall and device ms per step,
    device busy share, top kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity
    pos = first_pos
    with torch.no_grad():
        for _ in range(PROFILE_STEPS):
            _, cache = step(tokens[:, pos], pos, cache)
            pos += 1
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                _, cache = step(tokens[:, pos], pos, cache)
                pos += 1
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    print_profile(f"{name} decode", prof, wall_ms, PROFILE_STEPS)


def print_profile(label, prof, wall_ms, n_steps, top_k=5):
    """Wall and device ms per step, the device busy share, device ops per
    step and the kernels that take the most device time, of a profiled
    window of `n_steps` steps."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_k]
    print(f"profile {label}, {n_steps} steps (profiled): wall "
          f"{wall_ms / n_steps:.3f} ms/step, device {dev_ms / n_steps:.3f} "
          f"ms/step, busy {dev_ms / wall_ms:.1%}, {len(kernels) // n_steps} device "
          f"ops/step | top: " + "; ".join(f"{n[:60]} {t / n_steps:.3f} ms/step"
                                          for n, t in top))


def phase_kernels_k8_k10(cfg, params, device, batch):
    """K8 (fused LN + q/k/v + attention) on the random model's layer-0
    params, K9 (s8 self decode) and K10 (flash decode) at whisper-small
    shapes, each against its plain version, with times, bounds and the
    yardsticks (K8: the hm route it replaces and a library composite;
    K10: SDPA with one query row). Returns their three rows."""
    import torch
    import torch.nn.functional as F
    from sar_tpu_torch.models.whisper import cross_pad_len, layer_norm, linear, quantize_kv, tree_map
    from sar_tpu_torch.ops import flash_enc
    from sar_tpu_torch.ops.attic import attention, decode_self

    g = torch.Generator(device=device).manual_seed(SEED + 5)
    bf16 = torch.bfloat16
    D, H = cfg.d_model, cfg.encoder_heads
    hd = D // H
    S = cfg.max_source_positions
    T = cross_pad_len(S)
    rows = []

    # K8: a pre-LN residual with zero pad rows, layer 0's LN and q/k/v.
    p = tree_map(lambda a: a[0], params["encoder"]["layers"])
    x = torch.randn((batch, T, D), generator=g, device=device).to(bf16)
    x[:, S:] = 0
    args = (x, p["attn_ln"]["scale"], p["attn_ln"]["bias"], p["q"]["w"], p["q"]["b"],
            p["k"]["w"], p["v"]["w"], p["v"]["b"])
    k8 = lambda: flash_enc.encoder_attention_fused(*args, n_heads=H, t_valid=S)
    k8_plain = lambda: flash_enc.encoder_attention_fused_reference(*args, n_heads=H, t_valid=S)
    got, want = k8(), k8_plain()
    torch.cuda.synchronize()
    abs_err, rel_err = _attn_errors(got[:, :S], want[:, :S])

    def hm_route():
        """What "fq" replaces: the layer's plain LN and projections, then K1."""
        h = layer_norm(x, p["attn_ln"]["scale"], p["attn_ln"]["bias"])
        return flash_enc.encoder_attention_hm(linear(h, p["q"]) * hd ** -0.5, linear(h, p["k"]),
                                              linear(h, p["v"]), n_heads=H, t_valid=S)
    lns, lnb = p["attn_ln"]["scale"].to(bf16), p["attn_ln"]["bias"].to(bf16)
    zero = torch.zeros(D, dtype=bf16, device=device)
    key_mask = (torch.arange(T, device=device) < S)[None, None, None, :]

    def library():
        """F.layer_norm, three addmm and SDPA with the key mask."""
        h = F.layer_norm(x, (D,), lns, lnb, eps=1e-5).view(-1, D)
        heads = lambda y: y.view(batch, T, H, hd).transpose(1, 2)
        q = heads(torch.addmm(p["q"]["b"], h, p["q"]["w"]))
        k = heads(torch.addmm(zero, h, p["k"]["w"]))
        v = heads(torch.addmm(p["v"]["b"], h, p["v"]["w"]))
        return F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask)
    hm_err = _attn_errors(hm_route()[:, :S], want[:, :S])[0]
    lib_err = _attn_errors(library().transpose(1, 2).reshape(batch, T, D)[:, :S], want[:, :S])[0]
    ms, plain_ms = time_cuda(k8), time_cuda(k8_plain)
    hm_ms, library_ms = time_cuda(hm_route), time_cuda(library)
    b_ms, b_by = bound(6.0 * batch * S * D * D + 4.0 * batch * H * S * S * hd,
                       2 * batch * T * D * 2 + 3 * D * D * 2 + 2 * D * 2 + 2 * D * 4)
    print(f"K8 encoder_attention_fused [B={batch}, T_pad={T}, D={D}, H={H}, t_valid={S}] "
          f"bf16, layer 0's params: max_abs_err {abs_err:.3e} max_rel_err {rel_err:.3e} (tol "
          f"{ATTN_ABS_TOL}) | kernel {ms:.3f} ms plain {plain_ms:.3f} ms | composite: the hm "
          f"route (plain LN + 3 projections + K1) {hm_ms:.3f} ms, max_abs_err vs plain "
          f"{hm_err:.3e} | library composite (F.layer_norm + 3 addmm + SDPA, key mask) "
          f"{library_ms:.3f} ms, max_abs_err vs plain {lib_err:.3e} | bound {b_ms:.4f} ms ({b_by})")
    if abs_err > ATTN_ABS_TOL or rel_err > ATTN_REL_TOL:
        fail("K8 disagrees with its plain version")
    rows.append(dict(name="encoder_attention_fused", route="cuda",
                     source="sar_tpu_torch/csrc/flash_enc.cu",
                     replaces="sar_tpu/ops/flash_enc.py:261", max_abs_err=abs_err, ms=ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                     extra={"hm_route_ms": hm_ms, "library": "composite: F.layer_norm + 3 "
                            "addmm + scaled_dot_product_attention"}))
    del x, args, got, want

    # K9: an s8 self cache of every decoder layer at max_len, valid lengths
    # 1, 67 and max_len, each checked on every layer and timed per call
    # over a sweep of the layers (the slabs of all layers exceed the L2).
    L, Hd, Sm = cfg.decoder_layers, cfg.decoder_heads, cfg.max_target_positions
    Dd = Hd * 64
    kq, ks = quantize_kv(torch.randn((L, batch, Sm, Hd, 64), generator=g, device=device))
    vq, vs = quantize_kv(torch.randn((L, batch, Sm, Hd, 64), generator=g, device=device))
    qq, qs = quantize_kv(torch.randn((batch, Hd, 1, 64), generator=g, device=device) * 0.125)
    cache = (qq[:, :, 0].reshape(batch, Dd).contiguous(), qs.contiguous(),
             kq.reshape(L, batch, Sm, Dd), ks.transpose(2, 3).contiguous(),
             vq.reshape(L, batch, Sm, Dd), vs.transpose(2, 3).contiguous())
    del kq, ks, vq, vs
    by_len = {}
    for n in K9_LENGTHS:
        abs_err, rel_err = 0.0, 0.0
        for layer in range(L):
            o = decode_self.self_decode_attention(*cache, n, layer=layer, n_heads=Hd)
            r = decode_self.self_decode_reference(*cache, n, layer=layer, n_heads=Hd)
            a, rr = _attn_errors(o, r)
            abs_err, rel_err = max(abs_err, a), max(rel_err, rr)
        torch.cuda.synchronize()
        if abs_err > S8_ABS_TOL and rel_err > S8_REL_TOL:
            fail(f"K9 (n={n}) disagrees with its plain version")
        sweep = lambda fn: lambda: [fn(*cache, n, layer=layer, n_heads=Hd) for layer in range(L)]
        ms = time_cuda(sweep(decode_self.self_decode_attention)) / L
        plain_ms = time_cuda(sweep(decode_self.self_decode_reference)) / L
        b_ms, b_by = bound(4.0 * batch * Hd * n * 64,
                           2 * batch * n * Dd + 2 * 4 * batch * Hd * n + batch * Dd
                           + 4 * batch * Hd + 2 * batch * Dd, PEAK_INT8_OPS)
        by_len[n] = dict(max_abs_err=abs_err, max_rel_err=rel_err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by)
        print(f"K9 self_decode_attention s8 [L={L}, B={batch}, max_len={Sm}, D={Dd}, n={n}, all "
              f"{L} layers]: max_abs_err {abs_err:.3e} max_rel_err {rel_err:.3e} (tol "
              f"{S8_ABS_TOL} abs or {S8_REL_TOL} rel) | per call over a {L}-layer sweep: kernel "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms | bound {b_ms:.5f} ms ({b_by}) | library: none")
    rows.append(dict(name="self_decode_attention", route="cuda",
                     source="sar_tpu_torch/csrc/decode_self.cu",
                     replaces="sar_tpu/ops/attic/decode_self.py:80", library_ms=None,
                     **{k: v for k, v in by_len[Sm].items() if k != "max_rel_err"},
                     extra={"by_valid_len": by_len, "standalone": "no caller in either package"}))
    del cache

    # K10: q [B, H, 64] against the cross shape's k/v [B, H, S, 64], full
    # and masked to K10_MASKED_LEN, each with SDPA of one query row.
    q = (torch.randn((batch, H, 64), generator=g, device=device) * 0.125).to(bf16)
    k = torch.randn((batch, H, S, 64), generator=g, device=device).to(bf16)
    v = torch.randn((batch, H, S, 64), generator=g, device=device).to(bf16)
    variants = {}
    for label, n in (("full", None), ("masked", K10_MASKED_LEN)):
        got = attention.decode_attention(q, k, v, n)
        want = attention.decode_attention_reference(q, k, v, n)
        torch.cuda.synchronize()
        abs_err, rel_err = _attn_errors(got, want)
        if abs_err > ATTN_ABS_TOL or rel_err > ATTN_REL_TOL:
            fail(f"K10 ({label}) disagrees with its plain version")
        mask = None if n is None else (torch.arange(S, device=device) < n)[None, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                                      scale=1.0)
        lib_err = _attn_errors(sdpa()[:, :, 0], want)[0]
        ms = time_cuda(lambda: attention.decode_attention(q, k, v, n))
        plain_ms = time_cuda(lambda: attention.decode_attention_reference(q, k, v, n))
        library_ms = time_cuda(sdpa)
        rows_read = S if n is None else n
        b_ms, b_by = bound(4.0 * batch * H * rows_read * 64,
                           2 * batch * H * rows_read * 64 * 2 + 2 * batch * H * 64 * 2)
        variants[label] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=library_ms)
        print(f"K10 decode_attention {label} [B={batch}, H={H}, S={S}"
              f"{'' if n is None else f', valid_len={n}'}] bf16: max_abs_err {abs_err:.3e} "
              f"max_rel_err {rel_err:.3e} (tol {ATTN_ABS_TOL}) | kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms | library (SDPA, one query row) {library_ms:.4f} ms, "
              f"max_abs_err vs plain {lib_err:.3e} | bound {b_ms:.5f} ms ({b_by})")
    rows.append(dict(name="decode_attention", route="cuda",
                     source="sar_tpu_torch/csrc/decode_attention.cu",
                     replaces="sar_tpu/ops/attic/attention.py:64", **variants["full"],
                     extra={"masked": variants["masked"],
                            "standalone": "no caller in either package"}))
    return rows


def phase_fq(cfg, params, device, batch, n_batches, max_new_tokens):
    """The fused encoder path at full width: the greedy cell's clips through
    ASREvaluator(flash="fq") with the launch counters zeroed before and
    read after (K8 12 per batch, K1 0, K2 1 per batch, K3 12 per step); the
    card's fq encoder against its plain route; the fq tokens in lockstep
    with the "hm" evaluator's on the same clips, and both RTFx from the
    same run; one batch with an encoder q/v adapter (the downgrade to "hm":
    K8 0, K1 12); then one beam batch through beam_decode with its
    defaults (the unquantized classic cache, plain torch: K3 = K5 = 0).
    Returns the launch counts of each counted run by path."""
    import torch
    from sar_tpu_torch.decode import beam_decode
    from sar_tpu_torch.evaluation import ASREvaluator
    from sar_tpu_torch.models import lora as lora_lib
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.ops import mel as mel_ops

    g = torch.Generator(device=device).manual_seed(SEED + 1)      # the greedy cell's clips
    audio = [torch.randn((batch, mel_ops.N_SAMPLES), generator=g, device=device) * 0.1
             for _ in range(n_batches)]
    Le, Ld = cfg.encoder_layers, cfg.decoder_layers
    kw = dict(language="hindi", max_new_tokens=max_new_tokens, device=device)
    ev = ASREvaluator(cfg, params, flash="fq", **kw)
    hm = ASREvaluator(cfg, params, flash="hm", **kw)
    P = int(ev._prompt.shape[0])
    steps = [0]
    real_step = whisper.decode_step

    def counting_step(*a, **k):
        steps[0] += 1
        return real_step(*a, **k)

    def counted(fn):
        """(fn(), launch counts, decode steps, wall seconds), the counters
        zeroed before and read after."""
        torch.cuda.synchronize()
        reset_counts()
        steps[0] = 0
        whisper.decode_step = counting_step
        try:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            whisper.decode_step = real_step
        return out, read_counts(), steps[0], wall

    def mel(a):
        return mel_ops.log_mel_spectrogram(a, cfg.num_mel_bins,
                                           dtype=torch.bfloat16)[:, :, :cfg.num_audio_frames]

    def greedy(evaluator, clips):
        """mel -> prep -> dec per batch: [(tokens, fenced prep s, fenced decode s)]."""
        out = []
        for a in clips:
            f = mel(a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache = evaluator.prep(f)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tokens = evaluator.dec(cache)
            torch.cuda.synchronize()
            out.append((tokens, t1 - t0, time.perf_counter() - t1))
        return out

    greedy(ev, audio[:1])                                          # warm-up, not counted
    runs = {}
    for name, e in (("fq", ev), ("hm", hm)):
        runs[name] = counted(lambda e=e: greedy(e, audio))
    outs, c_fq, n_steps, _ = runs["fq"]
    audio_s = n_batches * batch * mel_ops.CHUNK_SECONDS
    for name, (o, c, n, wall) in runs.items():
        for i, (tokens, _, _) in enumerate(o):
            if tokens.shape != (batch, ev.total) or tokens.min() < 0 \
                    or tokens.max() >= cfg.vocab_size:
                fail(f"{name} batch {i}: bad token tensor {tuple(tokens.shape)}")
        prep_ms = 1e3 * statistics.mean(t for _, t, _ in o)
        print(f"{name} greedy: {audio_s} audio-s in {wall:.3f} s -> RTFx {audio_s / wall:.1f} | "
              f"prep (encoder + K2 cache) {prep_ms:.1f} ms per batch of {batch} | "
              f"{1e3 * sum(t for _, _, t in o) / n:.3f} ms/token-step over {n} steps | launches "
              f"{json.dumps(c)}")
    check_counts("fq greedy", c_fq, want_zero=tuple(
        k for k in KERNEL_NAMES if k not in ("encoder_attention_fused", "fused_kv_init",
                                             "cross_decode_attention_exact")))
    want = {"encoder_attention_fused": Le * n_batches, "encoder_attention_hm": 0,
            "fused_kv_init": n_batches, "cross_decode_attention_exact": Ld * n_steps}
    if any(c_fq[k] != v for k, v in want.items()):
        fail(f"fq greedy: launches {c_fq}, the path predicts {want}")

    # The card's fq encoder against its plain route (kernels=False), with
    # the hm encoder against its own plain route as the noise floor: the
    # same bf16 roundings at other points through 12 layers.
    f0 = mel(audio[0])
    with torch.no_grad():
        errs = {}
        for route in ("fq", "hm"):
            got = whisper.encode(params, f0, cfg, flash=route)
            want_e = whisper.encode(params, f0, cfg, flash=route, kernels=False)
            errs[route] = _attn_errors(got, want_e)
        del got, want_e
    (fa, fr), (ha, hr) = errs["fq"], errs["hm"]
    print(f"fq encode vs its plain route (kernels=False): max_abs_err {fa:.3e} max_rel_err "
          f"{fr:.3e} (need rel <= max({ATTN_REL_TOL}, 2 x the hm route's)) | hm encode vs its "
          f"plain route: max_abs_err {ha:.3e} max_rel_err {hr:.3e}")
    if fr > max(ATTN_REL_TOL, 2 * hr):
        fail("the fq encoder disagrees with its plain route")

    # Lockstep: both evaluators' caches of batch 0 fed the fq path's tokens.
    tok_f, tok_h = runs["fq"][0][0][0], runs["hm"][0][0][0]
    lock_steps = decode_steps(tok_f, cfg, P)
    cache_f, cache_h = ev.prep(f0), hm.prep(f0)
    agree, n, max_dlogit = 0, 0, 0.0
    with torch.no_grad():
        for pos in range(lock_steps):
            lf, cache_f = whisper.decode_step(params, tok_f[:, pos], pos, cache_f, cfg)
            lh, cache_h = whisper.decode_step(params, tok_f[:, pos], pos, cache_h, cfg)
            if not (torch.isfinite(lf).all() and torch.isfinite(lh).all()):
                fail(f"fq: non-finite logits at step {pos}")
            if pos + 1 >= P:
                agree += int((lf.argmax(-1) == lh.argmax(-1)).sum())
                n += batch
                max_dlogit = max(max_dlogit, (lf - lh).abs().max().item())
    del cache_f, cache_h
    lock = agree / max(n, 1)
    rows_equal = sum(int((a[0] == b[0]).all(1).sum())
                     for a, b in zip(runs["fq"][0], runs["hm"][0]))
    print(f"fq vs hm (batch 0): lockstep argmax agreement {lock:.4f} ({agree}/{n} row-steps, "
          f"need >= {LOCKSTEP_MIN_AGREEMENT}) | max |dlogit| {max_dlogit:.4e} | free-running "
          f"rows equal {rows_equal}/{n_batches * batch}, tokens equal "
          f"{(tok_f[:, P:] == tok_h[:, P:]).float().mean().item():.4f} (batch 0)")
    if lock < LOCKSTEP_MIN_AGREEMENT:
        fail("the fq path disagrees with the hm path")

    # An encoder q/v adapter: encode() takes "hm" (K1), not K8.
    lcfg = lora_lib.LoraConfig(r=LORA_RANK, alpha=LORA_ALPHA, dropout=0.0,
                               target_modules=("q_proj", "v_proj"))
    bank = lora_lib.map_with_path(
        lambda path, x: (torch.randn(x.shape, generator=g, device=device) * LORA_B_STD
                         if path[-1] == "b" else x),
        lora_lib.init_lora(g, cfg, lcfg))
    ev_l = ASREvaluator(cfg, params, lora=bank, lora_scale=lcfg.scale, flash="fq", **kw)
    out_l, c_lora, _, _ = counted(lambda: greedy(ev_l, audio[:1]))
    print(f"fq with an encoder q/v adapter (batch 0): launches {json.dumps(c_lora)}")
    if c_lora["encoder_attention_fused"] != 0 or c_lora["encoder_attention_hm"] != Le:
        fail(f"fq with a q/v adapter: K8 {c_lora['encoder_attention_fused']}, K1 "
             f"{c_lora['encoder_attention_hm']}; the downgrade predicts K8 0, K1 {Le}")
    del ev_l, out_l

    # beam_decode with its defaults (the JAX package's): the unquantized
    # classic cache, read in plain torch.
    K = BEAM_WIDTH
    enc = ev.encode(f0)
    tok_b, c_beam, n_beam, wall_b = counted(
        lambda: beam_decode(params, enc, cfg, ev._prompt, num_beams=K,
                            max_new_tokens=max_new_tokens))
    if tok_b.shape != (batch, ev.total) or tok_b.min() < 0 or tok_b.max() >= cfg.vocab_size:
        fail(f"default beam: bad token tensor {tuple(tok_b.shape)}")
    print(f"beam_decode with its defaults (unquantized classic cache, {batch} samples x {K} "
          f"beams): {1e3 * wall_b / n_beam:.3f} ms/token-step over {n_beam} steps (cache + "
          f"loop) | launches {json.dumps(c_beam)}")
    check_counts("default beam", c_beam, want_zero=KERNEL_NAMES)
    return {"fq": c_fq, "fq_lora": c_lora, "beam_default": c_beam}


def main() -> int:
    device, name, _ = phase_device()
    import torch
    from sar_tpu_torch.models.config import get_config
    phase_build()
    cfg = get_config(MODEL)
    params, n_params = make_model(cfg, device)
    rows = (phase_kernels(cfg, device, BATCH) + phase_k6(cfg, device, BATCH)
            + phase_kernels_k8_k10(cfg, params, device, BATCH))
    by_path = {"greedy": phase_e2e(cfg, params, n_params, device, BATCH, N_BATCHES,
                                   MAX_NEW_TOKENS),
               "routed": phase_routed(cfg, params, device, BATCH, MAX_NEW_TOKENS,
                                      profile="--profile" in sys.argv[1:]),
               "beam": phase_beam(cfg, params, device, BATCH, MAX_NEW_TOKENS,
                                  profile="--profile" in sys.argv[1:]),
               "train": phase_train(cfg, params, device, BATCH,
                                    profile="--profile" in sys.argv[1:]),
               "s8": phase_s8(cfg, params, device, BATCH, N_BATCHES, MAX_NEW_TOKENS,
                              profile="--profile" in sys.argv[1:]),
               **phase_fq(cfg, params, device, BATCH, N_BATCHES, MAX_NEW_TOKENS)}
    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "launches_by_path", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms", "shapes", "extra")
         if k in r}
        for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
