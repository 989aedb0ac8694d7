#!/usr/bin/env python3
"""Smoke run of the sar_tpu_torch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--profile | --kernels-only]

Phases, each printing its own line(s); any failure raises and exits non-zero.
Every decode loop of phases 4-11, 14-17 and 19 runs as the entry points run it: each
segment of the greedy or beam loop a CUDA graph captured at the first
batch of its shape and replayed after (decode/graphs.py); each such phase
warms up (and so captures) before its counted run, counts the decode
steps run and the host syncs with decode/segments.py's counters (replays
included) beside the launch counters, and holds the captured tokens to an
eager evaluator's (capture=False) on one batch.

1. device: requires CUDA (no CPU fallback), prints the card's name and its
   `nvidia-smi --query-gpu=name,power.limit` line, turns TF32 off.
2. build: compiles sar_tpu_torch/csrc/*.cu with nvcc (first use, one
   process per source, all at once) and prints the seconds it took.
3. kernels: K1 (encoder attention), K2 (cross-KV projection + int8
   quantization), K4 (K2 with a per-sample LoRA term on V, per-sample and
   broadcast slices of a 4-adapter r=16 bank), K3 (cross-attention
   decode), K5 (K3 with the queries of 4, then 5, beams folded per
   sample) and K7 (s8-scores cross-attention decode, greedy, 4 and 8
   beams folded; with its cluster split, GB/s, shared memory per block
   and ptxas registers and spills) at whisper-small shapes, batch 8, each
   against its plain PyTorch version on the card in bf16, with error
   limits, median CUDA-event times over 20 runs, the least time the card could take
   (bound) and, for K1, one library call computing the same function
   (scaled_dot_product_attention with the key mask; the port never calls
   it); for K2 and K4 a library composite (the bf16 cuBLAS GEMMs of every
   layer, then the torch quantize_rows) and its GEMMs alone, for K3 and K5
   the GB/s read; K1 also on a case that only the rounding of its probabilities to
   bf16 before the PV product decides. K6 (training's blockwise attention:
   forward, dQ, dK/dV) at the three whisper-small training shapes (encoder
   1500 x 1500, decoder causal 448 x 448, cross 448 x 1500, batch 8), each
   against its plain version (with its achieved TFLOP/s) and the output
   and gradients against autograd of the plain attention, with SDPA
   forward and forward + backward as the library yardstick. Then, on the
   random model of phase 4, K8 (the fused pre-LN
   + q/k/v projection + attention of encode(flash="fq")) on layer 0's
   params, x [8, 1536, 768] with 1500 valid rows, with two composite
   yardsticks (the hm route it replaces: plain LN and projections + K1;
   and F.layer_norm + 3 addmm + SDPA), and its LN + projection half alone
   (encoder_ln_qkv) against its plain q/k/v with F.layer_norm + 3 addmm
   as the yardstick; K9 (the parked s8 self decode) over a 12-layer
   head-minor int8 self cache of max_len 448 at valid lengths 1, 67 and
   448 (K7's kernel body, the same readings); K10 (the parked flash
   decode) at the cross shape (H=12, S=1500), full and masked, with SDPA of one query row, both timed cold over
   K10_SETS k/v sets (the warm reading beside it), and two runs compared
   bit for bit. K9 and K10 have no caller in either package and launch on
   no path. Last, K11 (self-attention over the classic int8 self cache)
   against its plain version (_attention_int8 over the same slice) at
   batch 8 and 128, a self cache of 228 rows read at position 200: error,
   ms per call over a 12-layer sweep, byte bound and share, ptxas; then
   its launches in a greedy loop at large-v3-turbo's decoder (random
   weights and encoder output, batch 8, 16 new tokens): 4 per step.
   K3 at the evaluation cells' batch 128 (phase_k3_large): the
   attribution line (K3 at whisper-small against probes of its loads
   alone, its loads with its cluster barriers, the same bytes as whole
   rows, and whole rows with an I2F or the byte trick per int8 value,
   all built from K3_PROBE_SRC); at whisper-small's and OWSM v4 medium's
   cross shapes both of K3's forms (cluster, large-batch) and the wrapper
   against the plain version, each form bit-stable, ms per call over a
   layer sweep, GB/s, the bound and the plain version's ms; then the
   captured greedy loop at whisper-small batch 128 (16 new tokens,
   captured then replayed): K3 12 per step run, all in the large-batch
   form.
   Then K12 (the E-Branchformer's depthwise time convolution with its
   zero padding, bias and gate or residual fused) and K13 (LayerNorm of
   bf16 rows) at OWSM v4 medium's encoder shapes, batch 128, T 768 with
   749 valid frames: K12 over the cgMLP's gate half (C 2048, gated by a
   view of the [.., 4096] activation) and the merge (C 2048, residual),
   the pad rows NaN; K13 at D 1024 over the padded rows and over the first
   749 frames read in place, and at D 2048 over the second half of a
   [.., 4096] activation; each value within one bf16 step of the plain
   version's, ms, the plain version's ms, a library call computing the
   same (F.conv1d(groups=C) in bf16 with its epilogue; F.layer_norm in
   bf16) and the bound (operations over the fp32 rate, bytes over HBM).
   Then K14 (the decoder step's residual add and LayerNorm) at [B, 1, d]
   rows of whisper-small B=8 and 128 and OWSM B=128: x_new bit-equal to
   the plain chain, h within one bf16 step, ms beside the plain chain's,
   the bf16 adds + F.layer_norm and the bound; and one eager whisper-small
   step at B=128 profiled with the plain chain and with K13/K14, its
   device ops by name beside those of the boundary chain alone.
4. greedy end to end: random bf16 whisper-small (seeded), two batches of 8
   random 30 s clips through the port's ASREvaluator (mel ->
   encode(flash="hm") -> the int8 cache -> greedy, 64 new tokens), with the
   launch counters zeroed before and read after (K3 = 12 per step run, none
   in its large-batch form at batch 8, K11
   = 12 per step run, K13 = 1 and K14 = 36 per step run, the steps and
   host syncs those the tokens predict); then the first batch
   through the plain path, compared in lockstep (both paths fed the same
   tokens) and free running.
5. routed end to end: the same model with a random 4-adapter bank (r=16,
   q_proj/v_proj, nonzero B) and a random LID head (layer 3, mean
   pooling) behind an AdapterRouter, 16 requests of 30 s audio submitted
   from 4 threads to a TranscriptionService (batches of 8, 64 new tokens),
   then the service's routed program with adapters [0,1,2,3,0,1,2,3]
   with its phases fenced, all with the launch counters zeroed before and read after
   (K1, K4, K3 > 0, K2 = 0; K11 = 12 per step run); then the routed plain path (kernels=False,
   flash=False) in lockstep and free running, and the LID overhead.
6. beam evaluation end to end: 16 synthetic whisper-small items through
   the port's DataLoader and collator into ASREvaluator(num_beams=4,
   64 new tokens).evaluate after one warm-up batch, printing WER/CER (of
   random weights: the path, not the accuracy), RTFx and ms per
   token-step, with the launch counters zeroed before and read after
   (K1, K2, K5 > 0; K3, K4 = 0; K11 = 0: the beams read the self cache
   through the ancestry); then the first batch through the plain
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
10. bench: the port's benchmark CLI (sar_tpu_torch.scripts.benchmark)
   in-process at whisper-small, batch 8, 64 new tokens, 2 timed
   iterations, one call per row: greedy over the int8 cache (head-minor
   and classic layouts), the unquantized (bf16) and the int4 caches, beam
   4 over int8, s8 scores, one train row (accumulation 2), one routed row
   (LID at layer 3) and one serving row (16 requests), each with the
   launch counters zeroed before and read after and the decode steps
   run counted by layout: K3 = 12 per head-minor greedy step (K2 > 0), K5 =
   12 per head-minor beam step, K7 = 12 per s8 step, no decode kernel on
   the classic, bf16 and int4 rows; every row present, without "error",
   its agreement keys in [0, 1].
11. graphs: the decode loop's compiled form at whisper-small, batch 8:
   greedy at 64 and 256 new tokens and beam 4 at 64, each through an
   eager evaluator (capture=False) and a captured one: the captured one's
   first batch (eager pass + capture) on its own line with its graphs,
   nodes, capture seconds and peak memory; then eager, captured,
   captured, eager on one batch (at 256 tokens captured, eager): tokens equal, ms per step run, steps
   needed and run, host syncs per batch, RTFx, peak memory, and launches
   equal; one decode step captured alone against its eager logits.
12. lid: LIDTrainer at whisper-small (random weights), tap layer 3, mean
   pooling, 4 synthetic languages: the frozen-feature pass
   (precompute_features; K1 = 4 per batch, counted), train_cached for
   LID_STEPS steps (ms per step) and evaluate_cached; then
   AdapterRouter.forward with labels under each strategy (hard, soft,
   threshold) on one batch: K6's forward 36 per teacher-forced pass (one
   pass for hard, one per adapter for soft), K1 = 4 for the LID tap. The
   trained head is saved for the route phase.
13. sweep: the LID sweep CLI (sar_tpu_torch.scripts.lid_sweep) in-process
   at whisper-small with its own random bf16 weights, tap layers 3 and -1
   x mean and attention pooling, 4 languages x 16 train and 8 eval items,
   batches of 16, 40 cached steps per cell, 3 timed taps: every cell
   present, accuracies in [0, 1], each confusion matrix summing to the
   eval count, ms per utterance per tap; K1 = (l + 1) per encoder call at
   layer l and 12 at -1, over the taps and both feature passes, every
   other counter 0.
14. route: route_infer's `route` at whisper-small with phase 4's weights,
   4 saved single adapters (r=16, q_proj/v_proj, nonzero B) and the lid
   phase's head: the synthetic test split, 4 utterances per language in
   mixed batches of 8, 64 new tokens, --oracle, --router_dir: the result
   keys, num_samples, lid_accuracy in [0, 1], the routing overhead beside
   the reference's < 10 ms target; K1 = 4 per LID pass + 12 per generate,
   every other counter 0 (generate decodes over the unquantized cache, as
   JAX's); then on one batch the routed and oracle generate walls, the
   router reloaded from --router_dir (its first batch captures: capture
   seconds) giving the same tokens, and an eager router's (capture=False)
   tokens equal to the captured ones; then analyze_adapters over the 4
   adapter directories (a row per target and layer, 6 pairwise
   similarities).
15. transcribe: single-file transcription at whisper-small with phase 4's
   weights, in process: a 75 s WAV at 44.1 kHz written here, through
   load_audio (the native polyphase resampler) into three 30 s windows;
   (a) plain long-form (batch_transcribe: exact encoder attention, the
   unquantized classic cache, every counter 0); (b) the transcribe CLI's
   `run` with --fallback --timestamps --word_timestamps --best_of 2 over
   the full temperature ladder at 64 new tokens (K1 12 per group, K2 one
   per decode pass, K3 12 per step run, one captured program for every
   pass), its text, segments and words written in every output format
   and parsed back, and two of its passes (T = 0 and T = 0.6 with one
   seed) captured against an eager runner: tokens equal, summed
   logprobs within 1e-3 and p(nospeech) within 1e-4; (c)
   --condition_on_previous_text: windows one after another, one program
   (graphs no more than its segments) replayed across them; (d) a 25 s
   window with --num_beams 4 --timestamps --language auto (no kernel);
   (e) (b)'s group again with a q/v adapter (K4 one per pass, K2 0). It
   prints RTFx per mode, the capture seconds, the passes per window and
   the escalation rate.
   (f) two files through the CLI's default path (batch_transcribe), which
   replays the program that (a) captured: no capture over the two.
16. stream: the streaming transcriber at whisper-small with phase 4's
   weights: a seeded random 40 s stream fed in 2 s chunks (20 updates, one
   rollover) at 64 new tokens, over the default unquantized cache (K1 12
   per decoded window, no other kernel) and over the int8 cache (K1 12, K2
   1 per window, K3 12 per step run): committed ids that never retract,
   one program captured at the first update and replayed after, and an
   eager transcriber (capture=False) with the same ids after every
   update, whose first update's K1/K2/K3 calls, at batch 1, are each held
   against their plain versions; ms per update (mean, p90), streaming
   RTF, capture seconds.
17. serve: the HTTP server (sar_tpu_torch.scripts.serve: build_service,
   make_server on 127.0.0.1:0) over phase 4's model with --kv_cache int8
   --batch_size 8: 8 concurrent POSTs of 30 s 16 kHz WAVs, one stereo 44.1
   kHz WAV, /healthz, /stats, a 400 and a 404, every text equal to the
   service's own transcription of the decoded audio (K1, K2, K3); then a
   routed server from the route phase's adapters and the lid phase's head
   (responses carry the detected language; K1, K4, K3). Round-trip p50/p95
   and batches per request.
18. mesh: the device-mesh path (sar_tpu_torch/parallel) on a NCCL group of
   one rank (a localhost rendezvous; two ranks cannot share the one card,
   so world > 1 runs in the CPU tests over gloo) and make_mesh(1, 1):
   ASRTrainer(mesh=) for MESH_TRAIN_STEPS steps of the train cell's shape
   (K6 36 of each kernel per microbatch), ASREvaluator(mesh=) over the
   greedy cell's clips (the classic int8 cache, captured: K1 12 per
   batch, no K2/K3) and a partial batch of MESH_PARTIAL, LIDTrainer(mesh=)
   for MESH_LID_STEPS streaming steps (exact attention: no kernel), each
   against the same run without a mesh: losses and bank, ids, losses
   equal; ms per step and per batch, mesh and meshless.
19. mixed: the six mixed-precision caches ((cross, self) precisions that
   differ: plain, int8, int4) at whisper-small, batch 8, 30 s clips, 64
   new tokens: per pair one encode (K1 12), the classic cache and the eager
   greedy loop (K11 12 per step on an int8 self side, K13 1 and K14 36
   per step, no other kernel: plain torch reads the rest), then the same
   through a DecodeRunner's CUDA graphs (captured first, then prep +
   replay: the same counts, as eager),
   tokens equal, the classic steps and host syncs the
   tokens predict, ms per token-step and the cache's bytes; then 4 beams
   for (int8, plain) (ancestry) and (int8, int4) (physical reorder), eager
   against captured, tokens equal.
20. owsm: OWSM v4 medium at its published widths (seeded random bf16
   weights of benchmarks/weights_owsm.py in the port's serving form)
   through ASREvaluator.from_audio as the owsm.eval.short cell runs it
   (ESPnet log-mel, the E-Branchformer encoder, the int8 cache, flash
   "auto", the captured greedy loop): OWSM_BATCHES batches of OWSM_BATCH
   seeded clips of 2-10 s, a language per row, 48 new tokens, after a
   warm-up batch, with the launch counters zeroed before and read after
   (per batch K12 2 per block, K13 6 per block + 1, K1 1 per block, K2 1;
   K3 and K11 one per decoder layer of every step run, K3 in the form the
   rule takes at batch OWSM_BATCH; K13 1 and K14 3 per layer in every step
   run; no other kernel),
   the steps and host syncs the tokens predict, RTFx; then the captured
   ids against an eager evaluator's on batch 0.
21. result: one JSON line with every kernel's numbers, then the last line
   {"ok": true, "device": {...}}.

With --kernels-only, it runs phases 1-3 and prints the kernel table
without launch counts and without the result line. To compare two trees in
one call, run it from another checkout's root with that tree's package
first on the path:
    python3 -c "import runpy, sys; sys.argv = ['chip_smoke.py', '--kernels-only']; \
runpy.run_path('<this file>', run_name='__main__')"

With --profile, the routed, beam and s8 phases also run PROFILE_STEPS
steady-state eager decode steps of the greedy, routed, beam and s8 paths
under torch.profiler (after the counted runs), the train phase one
optimizer step, and the graphs phase one captured and one eager
64-token greedy loop at batch 8 and one captured at PROFILE_BIG_BATCH, and
print, for each, the wall and device time per
step, the device busy share and the kernels that take the most time.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
PEAK_FP32_FLOPS = 67e12      # the CUDA cores' fp32 rate: K12 and K13 sum there
TIMING_RUNS = 20
SPIN_CYCLES = 50_000_000  # ~25 ms at the H100's clock: longer than any fn's host dispatch
# Tolerances, kernel vs its plain version on the same bf16 inputs. K1/K3:
# max|kernel - plain| and that over max|plain| (fp32 sums in another order
# plus the bf16 rounding of the outputs and of the probabilities). K2: int8
# values may differ by 1 where the two GEMMs sum in another order and land
# on either side of a .5 boundary; pad rows must be exactly 0 / scale 0.
ATTN_ABS_TOL = 2e-2
ATTN_REL_TOL = 2e-2
# K1 on a case where only the rounding of the probabilities to bf16 before
# the PV product decides the output (k1_rounding_case): exactly 0 when they
# are rounded, 4.88e-4 when they are not.
ROUNDING_CASE_TOL = 1e-6
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
# The mesh phase: train steps, the partial evaluator batch, LID steps, and
# how far a world-1 mesh run may sit from the meshless one (the same ops
# on the same data: equal but for any nondeterministic reduction).
MESH_TRAIN_STEPS, MESH_PARTIAL, MESH_LID_STEPS = 3, 6, 3
MESH_REL_TOL, MESH_ABS_TOL = 1e-6, 1e-7
# K6 against its plain version on the same bf16 inputs (one bf16 ulp of
# the largest entry is 3.9e-3 to 7.8e-3 of it):
# - the forward kernel, max |kernel - plain| over max |plain|: it rounds the
#   unnormalised p to bf16 (as the JAX kernel does), the plain version the
#   normalised p; read 3.9e-3 to 5.5e-3 at the three shapes;
# - the dQ and dK/dV kernels, given the same lse and di: the tensor cores
#   sum each product in k-slices of 16 in their own order, and their scores
#   differ from cuBLAS's in the last fp32 bits, so a bf16 rounding of p, of
#   ds or of the gradient can land on the other side of a tie. Per entry,
#   |kernel - plain| <= one bf16 ulp of max(|kernel|, |plain|) plus
#   K6_BWD_FLOOR of the largest |plain| entry (a flipped bf16(p) or bf16(ds)
#   moves one term of an entry's sum by an ulp of that term, which an entry
#   near 0 cannot absorb in its own ulp; read 1.2e-4 to 6.7e-4), and the
#   relative Frobenius error <= K6_BWD_FRO_TOL (read 5.1e-5 to 1.3e-4; a
#   dropped tile, a missed mask or a wrong di exceeds it many times);
# - the kernel path (custom op + autograd) against autograd of the plain
#   attention: the gradients go through another formulation of the softmax
#   backward; read 1.3e-3 to 7.5e-3.
K6_FWD_REL_TOL = 1e-2
K6_BWD_FLOOR = 2e-3
K6_BWD_FRO_TOL = 1e-3
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
S8_KERNEL_WIDTHS = (1, S8_BEAM_WIDTH, 8)   # K7's widths checked and timed in phase 3
# K9 (the parked s8 self decode) at whisper-small's max_len, valid lengths
# 1, a middle one and max_len; K10 (the parked flash decode) at the cross
# shape, full and masked to K10_MASKED_LEN. K9 fails only where both its
# absolute and relative errors pass the K7 limits (its outputs reach ~3,
# where one bf16 ulp is 1.6e-2).
K9_LENGTHS = (1, 67, 448)
# K11 at the evaluation cell's self cache (a 4-token prompt and 224 new
# tokens: 228 rows), read at position K11_POS, at BATCH and K11_BIG_BATCH.
K11_LEN, K11_POS, K11_BIG_BATCH = 228, 200, 128
# And its launches per step at large-v3-turbo's decoder, over this many new
# tokens.
K11_TURBO, K11_TURBO_TOKENS = "whisper-large-turbo", 16
K10_MASKED_LEN = 750
# K3 at the evaluation cells' batch, where it takes its large-batch form:
# label -> (heads, valid rows, S_pad, layers) of whisper-small's cross
# cache and OWSM v4 medium's; the captured greedy loop at that batch runs
# K3_BIG_TOKENS new tokens.
K3_BIG_BATCH, K3_BIG_TOKENS = 128, 16
K3_BIG_SHAPES = {"whisper-small": (12, 1500, 1536, 12), "owsm-v4-medium": (16, 749, 768, 18)}
# K12 and K13 at OWSM_MODEL's encoder, batch OWSM_KERNEL_BATCH (the
# owsm.eval.short cell's). Both sum in fp32, in another order than their
# plain versions, and round once to bf16, which can put the two on either
# side of a rounding boundary: a value may sit one bf16 step (2^-7 of it)
# plus BF16_STEP_FLOOR from the plain version's, and no further.
OWSM_MODEL, OWSM_KERNEL_BATCH = "owsm-v4-medium", 128
BF16_STEP, BF16_STEP_FLOOR = 2.0 ** -7, 1e-5
# K14 at the decoder step's sublayer boundaries: (model, batch) of the rows
# [B, 1, d] timed; the eager whisper-small step whose device ops are
# attributed, with and without the K13/K14 route, at batch K14_STEP_BATCH.
K14_CASES = (("whisper-small", 8), ("whisper-small", 128), ("owsm-v4-medium", 128))
K14_STEP_BATCH = 128
# The owsm phase: OWSM_BATCHES batches of OWSM_BATCH clips of
# OWSM_SECONDS, OWSM_NEW_TOKENS new tokens (the cell's).
OWSM_BATCH, OWSM_BATCHES, OWSM_NEW_TOKENS, OWSM_SECONDS = 16, 2, 48, (2.0, 10.0)
# K10 and its SDPA yardstick are timed cold: one call per set over
# K10_SETS independent k/v sets of the cross shape (5 x 36.9 MB, past the
# H100's 50 MB L2), so no call finds its k/v in L2. The warm reading (one
# set replayed) is printed beside it.
K10_SETS = 5
# K8's projection half against its plain version's q/k/v planes, per entry:
# |kernel - plain| <= one bf16 ulp of max(|kernel|, |plain|) (a sum that
# lands on the other side of a rounding tie) plus K8_HALF_FLOOR of the
# plane's largest |plain| entry (the LN statistics sum in another fp32
# order, which can move a bf16(h) by one ulp, and with it every sum that h
# enters by |w| ulp(h)).
K8_HALF_FLOOR = 2e-3
# Bench cell: the benchmark CLI's rows at BATCH, MAX_NEW_TOKENS new tokens,
# BENCH_ITERS timed iterations; the serving row's requests.
BENCH_ITERS = 2
BENCH_SERVING_REQUESTS = 16
# Graphs cell: eager against captured greedy at each of GRAPH_TOKENS new
# tokens (beam BEAM_WIDTH at the first).
GRAPH_TOKENS = (64, 256)
# With --profile, the captured 64-token greedy loop is also profiled at this
# batch, where the device sets the pace.
PROFILE_BIG_BATCH = 128
# LID cell: LID_ITEMS synthetic items per language, a cached-feature head
# trained LID_STEPS steps in batches of LID_BATCH, teacher-forced labels
# of LID_LABEL_LEN tokens for AdapterRouter.forward.
LID_ITEMS, LID_STEPS, LID_BATCH, LID_LABEL_LEN = 16, 40, 16, 64
# Sweep cell: the LID sweep CLI at SWEEP_LAYERS x SWEEP_POOLINGS over the 4
# target languages, SWEEP_TRAIN / SWEEP_EVAL items per language, batches of
# SWEEP_BATCH, SWEEP_STEPS cached steps per cell, SWEEP_ITERS timed taps.
SWEEP_LAYERS, SWEEP_POOLINGS = (3, -1), ("mean", "attention")
SWEEP_TRAIN, SWEEP_EVAL, SWEEP_BATCH, SWEEP_STEPS, SWEEP_ITERS = 16, 8, 16, 40, 3
# Route cell: route_infer over the synthetic test split, ROUTE_SAMPLES per
# language, in batches of BATCH, MAX_NEW_TOKENS new tokens, with --oracle;
# the reference's routing-overhead target, printed beside the reading.
ROUTE_SAMPLES = 4
ROUTING_TARGET_MS = 10.0


# Transcribe cell: a 75 s WAV at 44.1 kHz (resampled to 16 kHz: three 30 s
# windows, the last half empty) through the port's single-file
# transcription at MAX_NEW_TOKENS; the single-window beam mode on a 25 s
# WAV at 16 kHz; the fallback with best_of 2 over the full ladder.
TRANSCRIBE_SECONDS, TRANSCRIBE_SR = 75, 44100
SINGLE_WINDOW_SECONDS = 25
TRANSCRIBE_BEST_OF = 2
# Captured against eager fallback passes: summed logprobs and p(nospeech).
CAPTURED_LOGPROB_TOL, CAPTURED_NO_SPEECH_TOL = 1e-3, 1e-4
# Stream cell: a STREAM_SECONDS seeded random stream fed to a
# StreamingTranscriber in STREAM_CHUNK_SECONDS chunks (20 updates, one
# rollover) at MAX_NEW_TOKENS, over the default and the int8 cache.
STREAM_SECONDS, STREAM_CHUNK_SECONDS = 40, 2
# Serve cell: SERVE_CLIENTS concurrent POSTs of SERVE_SECONDS s WAVs (one
# device batch of BATCH), a SERVE_RESAMPLE_SECONDS s stereo 44.1 kHz WAV,
# the service's batching window SERVE_WAIT_MS.
SERVE_CLIENTS, SERVE_SECONDS, SERVE_RESAMPLE_SECONDS = BATCH, 30, 10
SERVE_WAIT_MS = 100.0


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


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()


def phase_device():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this smoke run "
              "drives the CUDA kernels and has no CPU fallback",
              file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    smi = card_line()
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
    log = _build.BUILD_LOG.splitlines()
    regs = [ln.strip() for ln in log if "registers" in ln]
    spills = [ln.strip() for ln in log
              if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    print(f"build: {secs:.1f} s ({len(_build.sources())} sources, "
          f"{'built' if _build.BUILD_SECONDS is not None else 'cached'}, "
          f"sm_90a) | ptxas: {' ; '.join(regs)} | spills: {' ; '.join(spills) or 'none'}")


def ptxas_of(kernel: str) -> str:
    """'R registers, N B spilled' of the kernel whose mangled name holds
    `kernel`, from the build's -Xptxas -v report."""
    from sar_tpu_torch.ops import _build
    lines = (_build.BUILD_ROOT / _build.source_hash() / "build.log").read_text().splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and kernel in ln:
            info = " ".join(lines[i + 1:i + 4])
            regs = info.split("Used ")[1].split(" registers")[0]
            spill = info.split("bytes stack frame, ")[1].split(" bytes spill stores")[0]
            return f"{regs} registers, {spill} B spilled"
    fail(f"no ptxas report for {kernel}")


def s8_split(S: int, length_mask: bool) -> tuple[int, int]:
    """K7's (length_mask False) or K9's cluster split of S rows: (C, rows)
    from the Python mirror, held to the C the library launches."""
    from sar_tpu_torch.ops import _build, decode_cross
    from sar_tpu_torch.ops.attic import decode_self
    C, rows = decode_self.cluster_split(S) if length_mask else decode_cross.s8_cluster_split(S)
    launched = _build.load().sar_s8_cluster_size(S, int(length_mask))
    if launched != C:
        fail(f"the s8 kernel launches clusters of {launched} for {S} rows; the mirror says {C}")
    return C, rows


def _bf16_ulp(x):
    """One bf16 ulp at each entry of x >= 0: 2^(floor(log2 x) - 7)."""
    import torch
    return torch.exp2(torch.floor(torch.log2(x.clamp_min(2.0 ** -126))) - 7)


def _bwd_errors(got, want):
    """K6's backward rule: (the largest per-entry excess over one bf16 ulp
    of max(|got|, |want|), in units of max |want|; the relative Frobenius
    error)."""
    import torch
    a, b = got.float(), want.float()
    if not bool(a.isfinite().all()):
        fail("kernel output has non-finite values")
    excess = ((a - b).abs() - _bf16_ulp(torch.maximum(a.abs(), b.abs()))).clamp_min(0)
    return (excess.max().item() / max(b.abs().max().item(), 1e-30),
            (a - b).norm().item() / max(b.norm().item(), 1e-30))


def _attn_errors(got, want):
    import torch
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not torch.isfinite(got.float()).all():
        fail("kernel output has non-finite values")
    return d, d / max(scale, 1e-30)


def k1_rounding_case(device) -> float:
    """max |o| of K1 on its valid rows for one head whose two valid keys
    score 0 and -2^-10 against every query, with values +1 and -1 (large
    garbage past them): the probabilities 1 and exp(-2^-10) = 0.99902 are
    equal once rounded to bf16, as the TPU kernel rounds them before the PV
    product, so the output is 0 (4.88e-4 with fp32 probabilities)."""
    import torch
    from sar_tpu_torch.ops import flash_enc
    g = torch.Generator(device=device).manual_seed(SEED + 5)
    q = torch.zeros((1, 16, 64), device=device)
    q[..., 0] = 1.0
    k = torch.randn((1, 16, 64), generator=g, device=device) * 3.0
    v = torch.randn((1, 16, 64), generator=g, device=device) * 3.0
    k[:, :2] = 0.0
    k[0, 1, 0] = -2.0 ** -10
    v[:, 0], v[:, 1] = 1.0, -1.0
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    o = flash_enc.encoder_attention_hm(q, k, v, n_heads=1, t_valid=2)
    return o[:, :2].float().abs().max().item()


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
    k1_flops = 4.0 * batch * H * S * S * hd
    b_ms, b_by = bound(k1_flops, 4 * batch * S_pad * D * 2)
    rounding = k1_rounding_case(device)
    print(f"K1 encoder_attention_hm [B={batch}, T_pad={S_pad}, D={D}, H={H}] bf16: "
          f"max_abs_err {abs_err:.3e} max_rel_err {rel_err:.3e} (tol {ATTN_ABS_TOL}) | "
          f"kernel {ms:.3f} ms = {k1_flops / ms / 1e9:.1f} TFLOP/s, plain {plain_ms:.3f} ms | "
          f"library (SDPA, key mask) {library_ms:.3f} ms, max_abs_err vs plain {lib_err:.3e} | "
          f"bound {b_ms:.4f} ms ({b_by}) | bf16-probability case: max |o| {rounding:.3e} "
          f"(need <= {ROUNDING_CASE_TOL})")
    if abs_err > ATTN_ABS_TOL or rel_err > ATTN_REL_TOL:
        fail("K1 disagrees with its plain version")
    if rounding > ROUNDING_CASE_TOL:
        fail("K1 does not round the probabilities to bf16 before the PV product")
    rows.append(dict(name="encoder_attention_hm", route="cuda",
                     source="sar_tpu_torch/csrc/flash_attn.cu",
                     replaces="sar_tpu/ops/flash_enc.py:90",
                     max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                     tflops=k1_flops / ms / 1e9, bound_ms=b_ms, bound_by=b_by,
                     library_ms=library_ms))
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
    # The library yardstick (the port never calls it): the 24 bf16 cuBLAS
    # GEMMs (x.Wk and x.Wv + bv per layer, rounded to bf16 by cuBLAS), then
    # the torch quantize_rows; and the GEMMs alone.
    k2_gemm_ms = time_cuda(lambda: _kv_gemms(enc, wk, wv, bv))
    k2_lib_ms = time_cuda(lambda: _kv_library(enc, wk, wv, bv, H, S))
    kv_bytes = (batch * S_pad * D * 2 + 2 * L * D * D * 2 + L * D * 2
                + 2 * L * batch * S_pad * D + 2 * L * batch * H * S_pad * 4)
    b_ms, b_by = bound(4.0 * L * batch * S * D * D, kv_bytes)
    print(f"K2 fused_kv_init [L={L}, B={batch}, S_pad={S_pad}, D={D}] bf16->s8: "
          f"int8 |d|<=1 on {flip:.3e} of entries (tol {KV_FLIP_FRAC_TOL}) | "
          f"scale max_rel_err {scale_err:.3e} (tol {KV_SCALE_REL_TOL}) | pad rows 0/0 | "
          f"dequantized max_abs_err {deq_err:.3e} | kernel {ms:.3f} ms = "
          f"{4.0 * L * batch * S * D * D / ms / 1e9:.1f} TFLOP/s, plain {plain_ms:.3f} ms | "
          f"library (24 cuBLAS GEMMs + torch quantize_rows) {k2_lib_ms:.3f} ms, the GEMMs "
          f"alone {k2_gemm_ms:.3f} ms | bound {b_ms:.4f} ms ({b_by})")
    rows.append(dict(name="fused_kv_init", route="cuda",
                     source="sar_tpu_torch/csrc/kv_init.cu",
                     replaces="sar_tpu/ops/kv_init.py:191",
                     max_abs_err=deq_err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=k2_lib_ms,
                     extra={"library": "24 cuBLAS GEMMs + torch quantize_rows",
                            "gemms_ms": k2_gemm_ms, "flip_frac": flip}))

    # K4: cross_v slices of a 4-adapter bank, per sample (the routed path)
    # and one slice broadcast over the batch (a single adapter).
    r = LORA_RANK
    bank_a = randn(L, 4, D, r, std=1.0 / r)
    bank_b = randn(L, 4, r, D, std=0.02)
    idx = torch.tensor(MIXED_ADAPTERS[:batch], device=device)
    scale = LORA_ALPHA / LORA_RANK
    forms = {"per-sample": (bank_a[:, idx].contiguous(), bank_b[:, idx].contiguous()),
             "broadcast": (bank_a[:, :1].contiguous(), bank_b[:, :1].contiguous())}
    k4_k2_ms = ms
    k4 = lambda fn, va, vb: lambda: fn(enc, wk, wv, bv, n_heads=H, t_valid=S,
                                       va=va, vb=vb, lora_scale=scale)
    k4_ms, k4_err, k4_flip = {}, 0.0, 0.0
    for form, (va, vb) in forms.items():
        got4 = k4(kv_init.fused_kv_init, va, vb)()
        want4 = k4(kv_init.fused_kv_init_reference, va, vb)()
        flip, scale_err, deq_err = _kv_errors(f"K4 {form}", got4, want4, S)
        if torch.equal(got4[2], got[2]):
            fail(f"K4 {form}: the LoRA term did not reach V")
        k4_err, k4_flip = max(k4_err, deq_err), max(k4_flip, flip)
        k4_ms[form] = (time_cuda(k4(kv_init.fused_kv_init, va, vb)),
                       time_cuda(k4(kv_init.fused_kv_init_reference, va, vb)),
                       time_cuda(lambda: _kv_library(enc, wk, wv, bv, H, S, va, vb, scale)),
                       time_cuda(lambda: _kv_gemms(enc, wk, wv, bv, va, vb, scale)))
        print(f"K4 fused_kv_init_lora {form} [L={L}, B={batch}, S_pad={S_pad}, D={D}, "
              f"r={r}] bf16->s8: int8 |d|<=1 on {flip:.3e} of entries (tol "
              f"{KV_FLIP_FRAC_TOL}) | scale max_rel_err {scale_err:.3e} (tol "
              f"{KV_SCALE_REL_TOL}) | pad rows 0/0 | dequantized max_abs_err {deq_err:.3e}"
              f" | kernel {k4_ms[form][0]:.3f} ms plain {k4_ms[form][1]:.3f} ms | library "
              f"(the K2 composite with x.va and u.vb) {k4_ms[form][2]:.3f} ms, the GEMMs "
              f"alone {k4_ms[form][3]:.3f} ms")
        del got4, want4
    ms, plain_ms, lib_ms, gemm_ms = k4_ms["per-sample"]
    b_ms, b_by = bound(4.0 * L * batch * S * D * (D + r), kv_bytes + 2 * L * batch * D * r * 2)
    print(f"K4 bound (per-sample slices) {b_ms:.4f} ms ({b_by}) | K4 / K2 in this run "
          f"{ms / k4_k2_ms:.3f}")
    rows.append(dict(name="fused_kv_init_lora", route="cuda",
                     source="sar_tpu_torch/csrc/kv_init.cu",
                     replaces="sar_tpu/ops/kv_init.py:172",
                     max_abs_err=k4_err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     extra={"library": "the K2 composite with the x.va and u.vb GEMMs",
                            "gemms_ms": gemm_ms, "flip_frac": k4_flip,
                            "broadcast_ms": k4_ms["broadcast"][0]}))

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
    big = phase_k3_large(cfg, device)
    rows.append(dict(name="cross_decode_attention_exact", route="cuda",
                     source="sar_tpu_torch/csrc/decode_cross.cu",
                     replaces="sar_tpu/ops/decode_cross.py:219",
                     max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=None,
                     extra={"gbps": slab_mb / ms, "big_batch": big}))

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
        k5[K] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     gbps=slab_mb / ms)
    rows.append(dict(name="cross_decode_attention_exact_beam", route="cuda",
                     source="sar_tpu_torch/csrc/decode_cross.cu",
                     replaces="sar_tpu/ops/decode_cross.py:219",
                     library_ms=None,
                     **{k: v for k, v in k5[BEAM_WIDTH].items() if k != "gbps"},
                     extra={"beam_width": BEAM_WIDTH, "gbps": k5[BEAM_WIDTH]["gbps"],
                            "other_widths": {K: v for K, v in k5.items() if K != BEAM_WIDTH}}))

    # K7: s8 scores over the same slabs, the query quantized per (row,
    # head) as decode_step does; greedy (q [B, D]), 4 beams folded (the s8
    # beam path's width) and 8 (the largest instance, a row's extra).
    from sar_tpu_torch.models.whisper import quantize_kv
    C, rows_per = s8_split(S_pad, False)
    k7, k7_extra = {}, {}
    for K in S8_KERNEL_WIDTHS:
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
        smem, regs = decode_cross.s8_shared_bytes(K, S_pad), ptxas_of(f"s8_decode_kernelILi{K}ELi0E")
        print(f"K7 cross_decode_attention s8 [B={batch}, K={K}, S_pad={S_pad}, D={D}, all {L} "
              f"layers] s8 q, s8 cache: max_abs_err {abs_err:.3e} max_rel_err {rel_err:.3e} "
              f"(tol {S8_ABS_TOL} abs, {S8_REL_TOL} rel) | per call over a {L}-layer sweep: "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms | {slab_mb:.1f} MB of int8 slab + scales -> "
              f"{slab_mb / ms:.1f} GB/s | bound {b_ms:.4f} ms ({b_by}) | clusters of C={C} blocks "
              f"of {rows_per} rows per (head, sample) | shared memory {smem} B per block | ptxas "
              f"{regs} | library: none (no PyTorch call takes s8 attention with per-row scales "
              f"and re-quantized probabilities)")
        if abs_err > S8_ABS_TOL or rel_err > S8_REL_TOL:
            fail(f"K7 (K={K}) disagrees with its plain version")
        k7[K] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        k7_extra[K] = dict(gbps=slab_mb / ms, smem=smem, ptxas=regs)
    for K, row_name in ((1, "cross_decode_attention"), (S8_BEAM_WIDTH, "cross_decode_attention_beam")):
        rows.append(dict(name=row_name, route="cuda", source="sar_tpu_torch/csrc/decode_s8.cu",
                         replaces="sar_tpu/ops/decode_cross.py:109", library_ms=None,
                         beam_width=K, **k7[K],
                         extra={"cluster": C, "slice_rows": rows_per, **k7_extra[K],
                                "other_widths": {W: {**v, **k7_extra[W]} for W, v in k7.items()
                                                 if W != K}}))
    del kq, ks, vq, vs, got
    rows.append(phase_k11(cfg, device, batch))
    return rows


def phase_k11(cfg, device, batch) -> dict:
    """K11 (self-attention over the classic int8 self cache) against its
    plain version (_attention_int8 over the same slice) at whisper-small,
    batch `batch` and K11_BIG_BATCH (the evaluation cell's), a self cache of
    K11_LEN rows (224 new tokens after a 4-token prompt) read at position
    K11_POS: every layer checked, each call timed over a 12-layer sweep (the
    layers' caches exceed the 50 MB L2 at the larger batch, as in the decode
    loop). Bound: the int8 rows 0..pos of K and V with their fp32 scales,
    plus q and the output, over the HBM rate. Then K11's launches in a
    greedy loop at K11_TURBO's decoder: one per layer of every step."""
    import torch
    from sar_tpu_torch.models.whisper import quantize_kv
    from sar_tpu_torch.ops import decode_self_exact as dse

    g = torch.Generator(device=device).manual_seed(SEED + 11)
    L, H = cfg.decoder_layers, cfg.decoder_heads
    hd = cfg.d_model // H
    T, pos = K11_LEN, K11_POS
    by_batch = {}
    for B in (batch, K11_BIG_BATCH):
        kq, ks = quantize_kv(torch.randn((L, B, H, T, hd), generator=g, device=device))
        vq, vs = quantize_kv(torch.randn((L, B, H, T, hd), generator=g, device=device))
        q = (torch.randn((B, H, 1, hd), generator=g, device=device) * hd ** -0.5).to(
            torch.bfloat16)
        abs_err, rel_err = 0.0, 0.0
        for layer in range(L):
            o = dse.self_decode_attention_exact(q, kq, ks, vq, vs, layer=layer, pos=pos, n=T)
            r = dse.self_decode_reference_exact(q, kq, ks, vq, vs, layer=layer, pos=pos, n=T)
            a, rr = _attn_errors(o, r)
            abs_err, rel_err = max(abs_err, a), max(rel_err, rr)
        torch.cuda.synchronize()

        def sweep(fn):
            return lambda: [fn(q, kq, ks, vq, vs, layer=layer, pos=pos, n=T)
                            for layer in range(L)]
        ms = time_cuda(sweep(dse.self_decode_attention_exact)) / L
        plain_ms = time_cuda(sweep(dse.self_decode_reference_exact)) / L
        nbytes = B * H * ((pos + 1) * 2 * (hd + 4) + 2 * hd * 2)
        b_ms, b_by = bound(4.0 * B * H * (pos + 1) * hd, nbytes)
        regs = ptxas_of("self_decode_exact_kernel")
        print(f"K11 self_decode_attention_exact [B={B}, H={H}, T={T}, pos={pos}, all {L} "
              f"layers] bf16 q, s8 self cache: max_abs_err {abs_err:.3e} max_rel_err "
              f"{rel_err:.3e} (tol {ATTN_ABS_TOL}) | per call over a {L}-layer sweep: kernel "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms | {nbytes / 1e6:.2f} MB of int8 rows + "
              f"scales -> {nbytes / 1e6 / ms:.1f} GB/s | bound {b_ms:.4f} ms ({b_by}) = "
              f"{100 * b_ms / ms:.1f}% | ptxas {regs} | library: none (no PyTorch call takes "
              f"int8 K/V with per-row scales)")
        if abs_err > ATTN_ABS_TOL or rel_err > ATTN_REL_TOL:
            fail(f"K11 (B={B}) disagrees with its plain version")
        by_batch[B] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, share=b_ms / ms, gbps=nbytes / 1e6 / ms)
        del kq, ks, vq, vs, q

    # The dispatch at large-v3-turbo's decoder (4 layers, 20 heads): the
    # greedy loop over its int8 head-minor cache, from a random encoder
    # output, launches K11 once per layer of every step run.
    from sar_tpu_torch.decode.greedy import greedy_decode_from_cache
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.models.config import get_config
    tcfg = get_config(K11_TURBO)
    tparams = whisper.cast_params(whisper.init_params(tcfg, g, device), torch.bfloat16)
    enc = (torch.randn((batch, tcfg.max_source_positions, tcfg.d_model), generator=g,
                       device=device) * 0.5).to(torch.bfloat16)
    prompt = tcfg.prompt_ids("hindi")
    cache = whisper.init_cache(tparams, enc, tcfg, len(prompt) + K11_TURBO_TOKENS, **INT8)
    reset_counts()
    greedy_decode_from_cache(tparams, cache, tcfg, prompt)
    torch.cuda.synchronize()
    c, steps = read_counts(), read_steps()["greedy"]
    check_k11(f"{K11_TURBO} greedy, batch {batch}, {steps} steps", c,
              tcfg.decoder_layers * steps)
    del tparams, enc, cache
    row = by_batch[batch]
    return dict(name=K11_NAME, route="cuda", source="sar_tpu_torch/csrc/decode_self_exact.cu",
                replaces="none: sar_tpu/models/whisper.py::_attention_int8 is plain jnp",
                library_ms=None, **{k: v for k, v in row.items() if k not in ("share", "gbps")},
                extra={"T": T, "pos": pos, "share": row["share"], "gbps": row["gbps"],
                       "big_batch": {K11_BIG_BATCH: by_batch[K11_BIG_BATCH]}})


def _step_errors(got, want) -> tuple[float, int]:
    """(max |got - want|, the values further apart than one bf16 step of
    the plain version's value plus BF16_STEP_FLOOR) over finite outputs."""
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        return float("inf"), got.numel()
    d = (got - want).abs()
    return d.max().item(), int((d > BF16_STEP * want.abs() + BF16_STEP_FLOOR).sum())


def phase_k12_k13(device) -> list:
    """K12 and K13 against their plain versions at OWSM_MODEL's encoder
    shapes, batch OWSM_KERNEL_BATCH, T padded to 768 with 749 valid frames
    (the module docstring's phase 3): errors, ms, the plain version's ms,
    the library call's ms and the bound. Both kernels' bounds count the
    valid frames, as benchmarks/counts/owsm.py does."""
    import torch
    import torch.nn.functional as F

    from sar_tpu_torch.models.config import get_config
    from sar_tpu_torch.models.whisper import cross_pad_len
    from sar_tpu_torch.ops import dwconv
    from sar_tpu_torch.ops import layer_norm as ln_ops

    cfg = get_config(OWSM_MODEL)
    g = torch.Generator(device=device).manual_seed(SEED + 12)
    bf16 = torch.bfloat16
    B, S, D = OWSM_KERNEL_BATCH, cfg.max_source_positions, cfg.d_model
    T = cross_pad_len(S)
    rows = []

    def randn(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=g, device=device) * std + mean).to(bf16)

    k12 = {}
    for case, C, K, gated in (("cgmlp gate", cfg.cgmlp_dim // 2, cfg.cgmlp_kernel, True),
                              ("merge", 2 * D, cfg.merge_kernel, False)):
        x = randn(B, T, C)
        x[:, S:] = float("nan")                 # pad rows: read as zeros, never summed
        w, b = randn(C, 1, K, std=0.2), randn(C, std=0.1)
        gate = randn(B, T, 2 * C)[..., :C] if gated else None
        kw = dict(t_valid=S, gate=gate, residual=not gated)
        got = dwconv.depthwise_conv_time(x, w, b, **kw)
        want = dwconv.depthwise_conv_time_reference(x, w, b, **kw)
        torch.cuda.synchronize()
        abs_err, apart = _step_errors(got[:, :S], want[:, :S])

        def library(x=x, w=w, b=b, gate=gate, C=C, K=K):
            """F.conv1d(groups=C) in bf16 over the masked input on the
            [B, C, T] layout, then the epilogue in bf16."""
            xm = torch.where(torch.arange(T, device=device)[None, :, None] < S, x, 0.0)
            y = F.conv1d(xm.transpose(1, 2), w, b, padding=K // 2, groups=C).transpose(1, 2)
            return y * gate if gate is not None else y + xm
        ms = time_cuda(lambda: dwconv.depthwise_conv_time(x, w, b, **kw))
        plain_ms = time_cuda(lambda: dwconv.depthwise_conv_time_reference(x, w, b, **kw))
        lib_ms = time_cuda(library)
        values = float(B) * S * C
        b_ms, b_by = bound(values * (2.0 * K + 2.0),
                           2.0 * values * (3 if gated else 2) + 2.0 * C * (K + 1),
                           PEAK_FP32_FLOPS)
        print(f"K12 depthwise_conv_time {case} [B={B}, T={T}, t_valid={S}, C={C}, K={K}] bf16: "
              f"max_abs_err {abs_err:.3e}, {apart} values over one bf16 step | kernel {ms:.4f} "
              f"ms plain {plain_ms:.4f} ms library {lib_ms:.4f} ms | bound {b_ms:.4f} ms "
              f"({b_by}) = {100 * b_ms / ms:.1f}% | ptxas {ptxas_of('dwconv_time_kernel')}")
        if apart:
            fail(f"K12 ({case}) disagrees with its plain version")
        k12[case] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms)
        del x, w, b, gate, got, want
    rows.append(dict(name="depthwise_conv_time", route="cuda",
                     source="sar_tpu_torch/csrc/dwconv_time.cu",
                     replaces="none: the JAX package has no E-Branchformer", **k12["merge"],
                     extra={"cgmlp gate": k12["cgmlp gate"]}))

    k13 = {}
    for case, width, D_ln, view in (("d1024 padded", D, D, lambda u: u),
                                    ("d1024 valid frames", D, D, lambda u: u[:, :S]),
                                    ("cgmlp gate d2048", cfg.cgmlp_dim, cfg.cgmlp_dim // 2,
                                     lambda u: u[..., cfg.cgmlp_dim // 2:])):
        x = view(randn(B, T, width, std=3.0, mean=0.5))
        scale = 1.0 + 0.1 * torch.randn((D_ln,), generator=g, device=device)
        bias = 0.1 * torch.randn((D_ln,), generator=g, device=device)
        eps = cfg.ln_eps
        got = ln_ops.layer_norm(x, scale, bias, eps)
        want = ln_ops.layer_norm_reference(x, scale, bias, eps)
        torch.cuda.synchronize()
        abs_err, apart = _step_errors(got, want)
        ms = time_cuda(lambda: ln_ops.layer_norm(x, scale, bias, eps))
        plain_ms = time_cuda(lambda: ln_ops.layer_norm_reference(x, scale, bias, eps))
        s16, b16 = scale.to(bf16), bias.to(bf16)
        lib_ms = time_cuda(lambda: F.layer_norm(x, (D_ln,), s16, b16, eps))
        n = float(x.shape[0] * x.shape[1])
        b_ms, b_by = bound(8.0 * n * D_ln, 4.0 * n * D_ln + 8.0 * D_ln, PEAK_FP32_FLOPS)
        print(f"K13 layer_norm {case} [{x.shape[0]}, {x.shape[1]}, {D_ln}] bf16 rows {width} "
              f"wide, fp32 scale and bias: max_abs_err {abs_err:.3e}, {apart} values over one "
              f"bf16 step | kernel {ms:.4f} ms plain {plain_ms:.4f} ms library (F.layer_norm, "
              f"bf16) {lib_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by}) = {100 * b_ms / ms:.1f}% | "
              f"ptxas {ptxas_of('layer_norm_rows_kernel')}")
        if apart:
            fail(f"K13 ({case}) disagrees with its plain version")
        k13[case] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms)
        del x, got, want
    rows.append(dict(name="layer_norm", route="cuda", source="sar_tpu_torch/csrc/layer_norm.cu",
                     replaces="none: the JAX package has no E-Branchformer",
                     **k13["d1024 padded"],
                     extra={k: v for k, v in k13.items() if k != "d1024 padded"}))
    return rows


# K6 at the three attentions of a whisper-small training step: (label, Tq,
# Tk, causal). The decoder's T is the CLI's label length.
K6_SHAPES = (("encoder", 1500, 1500, False), ("decoder self", TRAIN_LABEL_LEN,
                                               TRAIN_LABEL_LEN, True),
             ("cross", TRAIN_LABEL_LEN, 1500, False))
K6_REPLACES = "sar_tpu/ops/flash.py:52 flash_mha -> jax pallas/ops/tpu/flash_attention.py:"


# K3's attribution probes (built here with nvcc, outside the package: no
# path calls them). Each reads layer `layer` of the int8 head-minor cache
# kq/vq [L, B, S, D] with its scales ks/vs [L, B, H, S] and xors what it
# read into one word per warp, so the loads cannot be dropped:
#   probe_pattern<false>: K3's loads and nothing else, on K3's grid (C, H,
#     B): a block's k rows 8 bytes a lane, U rows a lane in flight, with
#     their scales, and its v rows by cp.async 16 bytes a lane into a ring
#     of 64-row stages, all issued before any is used;
#   probe_pattern<true>: the same in clusters of C with K3's two cluster
#     barriers (after the k rows, after the v rows);
#   probe_rows: the same bytes as whole contiguous rows, 16 bytes a lane,
#     four loads a lane in flight, on 8 blocks per SM;
#   probe_convert<0|1>: probe_rows' k and v slabs with every int8 value
#     turned into fp32 and summed with an fma, by I2F (0, as K3 does) or by
#     the exact byte trick (1: PRMT the biased byte under 2^23's exponent,
#     subtract 2^23 + 128).
K3_PROBE_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace cg = cooperative_groups;

constexpr int HD = 64, NT = 256, TPR = 8, RG = NT / TPR, U = 8, STAGE_ROWS = 64, NS = 8;

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
      (uint32_t)__cvta_generic_to_shared(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
      (uint32_t)__cvta_generic_to_shared(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void put(unsigned* out, unsigned x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, o);
  const size_t block = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if ((threadIdx.x & 31) == 0) out[block * (blockDim.x / 32) + threadIdx.x / 32] = x;
}

template <bool BARRIERS>
__global__ void __launch_bounds__(NT, 4) probe_pattern(
    const int8_t* __restrict__ kq, const float* __restrict__ ks, const int8_t* __restrict__ vq,
    const float* __restrict__ vs, unsigned* out, int B, int S, int D, int H, int layer,
    int slice) {
  __shared__ __align__(16) int8_t ring[NS * STAGE_ROWS * HD];
  __shared__ float vsc[2048];
  const int tid = threadIdx.x, part = tid % TPR, rg = tid / TPR;
  const int rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lo = min(S, rank * slice), hi = min(S, lo + slice), n = hi - lo;
  const size_t plane = (size_t)layer * B + b;
  const int8_t* kb = kq + plane * S * D + h * HD;
  const int8_t* vb = vq + plane * S * D + h * HD;
  const float* ksb = ks + (plane * H + h) * S;
  const float* vsb = vs + (plane * H + h) * S;
  unsigned x = 0;
  uint2 raw[U];
  float kscale[U];
  auto load_k = [&](int s0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + u * RG + rg;
      raw[u] = s < hi ? __ldg(reinterpret_cast<const uint2*>(kb + (size_t)s * D + part * 8))
                      : make_uint2(0, 0);
      kscale[u] = s < hi ? __ldg(ksb + s) : 0.f;
    }
  };
  auto load_v = [&](int j) {
    const int r = j * STAGE_ROWS + tid / 4;
    cp16(ring + ((j % NS) * STAGE_ROWS + tid / 4) * HD + (tid % 4) * 16,
         vb + (size_t)(lo + (r < n ? r : 0)) * D + (tid % 4) * 16, r < n);
  };
  const int v_stages = (n + STAGE_ROWS - 1) / STAGE_ROWS;
  load_k(lo);
  for (int i = tid; i < n; i += NT) cp4(vsc + i, vsb + lo + i, true);
  for (int j = 0; j < NS && j < v_stages; ++j) load_v(j);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int s0 = lo; s0 < hi; s0 += U * RG) {
    if (s0 != lo) load_k(s0);
#pragma unroll
    for (int u = 0; u < U; ++u) x ^= raw[u].x ^ raw[u].y ^ __float_as_uint(kscale[u]);
  }
  if (BARRIERS) cg::this_cluster().sync();
  for (int j = 0; j < v_stages; j += NS) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    for (int i = tid; i < min(NS, v_stages - j) * STAGE_ROWS * HD / 16; i += NT)
      x ^= reinterpret_cast<const uint4*>(ring)[i].x;
    __syncthreads();
    for (int jj = j + NS; jj < j + 2 * NS && jj < v_stages; ++jj) load_v(jj);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int i = tid; i < n; i += NT) x ^= __float_as_uint(vsc[i]);
  if (BARRIERS) cg::this_cluster().sync();
  put(out, x);
}

__global__ void __launch_bounds__(NT) probe_rows(
    const uint4* __restrict__ k, const uint4* __restrict__ v, const uint4* __restrict__ ksl,
    const uint4* __restrict__ vsl, unsigned* out, size_t n_kv, size_t n_s) {
  unsigned x = 0;
  const size_t stride = (size_t)gridDim.x * NT, first = (size_t)blockIdx.x * NT + threadIdx.x;
  const uint4* src[4] = {k, v, ksl, vsl};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const size_t n = a < 2 ? n_kv : n_s;
    for (size_t i = first; i < n; i += 4 * stride) {
      uint4 r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = i + j * stride < n ? __ldg(src[a] + i + j * stride)
                                                            : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < 4; ++j) x ^= r[j].x ^ r[j].y ^ r[j].z ^ r[j].w;
    }
  }
  put(out, x);
}

template <int MODE>
__device__ __forceinline__ float s8_at(uint32_t w, int i) {
  if (MODE == 0) return (float)(int8_t)(w >> (8 * i));
  const uint32_t u = w ^ 0x80808080u;
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - 8388736.f;
}

template <int MODE>
__global__ void __launch_bounds__(NT) probe_convert(
    const uint4* __restrict__ k, const uint4* __restrict__ v, unsigned* out, size_t n_kv) {
  float acc = 0.f, w[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) w[e] = 1.f + 0.01f * (float)((threadIdx.x + e) & 7);
  const size_t stride = (size_t)gridDim.x * NT, first = (size_t)blockIdx.x * NT + threadIdx.x;
  const uint4* src[2] = {k, v};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    for (size_t i = first; i < n_kv; i += 4 * stride) {
      uint4 r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = i + j * stride < n_kv ? __ldg(src[a] + i + j * stride)
                                                               : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t ww[4] = {r[j].x, r[j].y, r[j].z, r[j].w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc = fmaf(w[4 * q + e], s8_at<MODE>(ww[q], e), acc);
      }
    }
  }
  put(out, __float_as_uint(acc));
}

extern "C" int k3_probe(int kind, const void* kq, const void* ks, const void* vq,
                        const void* vs, void* out, int L, int B, int S, int D, int H,
                        int layer, int cluster, int slice, int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t plane = (size_t)B * S * D, splane = (size_t)B * H * S;
  const int8_t* k8 = static_cast<const int8_t*>(kq) + (size_t)layer * plane;
  const int8_t* v8 = static_cast<const int8_t*>(vq) + (size_t)layer * plane;
  const float* ksl = static_cast<const float*>(ks) + (size_t)layer * splane;
  const float* vsl = static_cast<const float*>(vs) + (size_t)layer * splane;
  unsigned* o = static_cast<unsigned*>(out);
  if (kind == 0 || kind == 1) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(cluster, H, B);
    config.blockDim = dim3(NT);
    config.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kind == 1 ? cluster : 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    const cudaError_t err = kind == 1
        ? cudaLaunchKernelEx(&config, probe_pattern<true>, static_cast<const int8_t*>(kq),
                             static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
                             static_cast<const float*>(vs), o, B, S, D, H, layer, slice)
        : cudaLaunchKernelEx(&config, probe_pattern<false>, static_cast<const int8_t*>(kq),
                             static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
                             static_cast<const float*>(vs), o, B, S, D, H, layer, slice);
    if (err != cudaSuccess) return (int)err;
  } else if (kind == 2) {
    probe_rows<<<blocks, NT, 0, st>>>(reinterpret_cast<const uint4*>(k8),
                                      reinterpret_cast<const uint4*>(v8),
                                      reinterpret_cast<const uint4*>(ksl),
                                      reinterpret_cast<const uint4*>(vsl), o, plane / 16,
                                      splane * 4 / 16);
  } else if (kind == 3 || kind == 4) {
    auto kernel = kind == 3 ? probe_convert<0> : probe_convert<1>;
    kernel<<<blocks, NT, 0, st>>>(reinterpret_cast<const uint4*>(k8),
                                  reinterpret_cast<const uint4*>(v8), o, plane / 16);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""
K3_PROBES = ("K3's loads alone", "K3's loads + its cluster barriers", "whole contiguous rows",
             "rows + I2F per value", "rows + byte trick per value")


def phase_k14(device) -> list:
    """K14 against its plain version at the decoder step's boundary rows
    [B, 1, d] of K14_CASES (the module docstring's phase 3): x_new bit-equal,
    h within one bf16 step, ms, the plain chain's ms (`linear`'s bias add,
    the residual add, the fp32 LayerNorm), a library composite's (the bf16
    adds and F.layer_norm) and the bound; then k14_attribution."""
    import torch
    import torch.nn.functional as F

    from sar_tpu_torch.models.config import get_config
    from sar_tpu_torch.ops import layer_norm as ln_ops

    g = torch.Generator(device=device).manual_seed(SEED + 14)
    bf16 = torch.bfloat16
    k14 = {}
    for model, B in K14_CASES:
        cfg = get_config(model)
        D, eps = cfg.d_model, cfg.ln_eps
        x = (3.0 * torch.randn((B, 1, D), generator=g, device=device) + 0.5).to(bf16)
        y = torch.randn((B, 1, D), generator=g, device=device).to(bf16)
        b = (0.1 * torch.randn((D,), generator=g, device=device)).to(bf16)
        scale = 1.0 + 0.1 * torch.randn((D,), generator=g, device=device)
        bias = 0.1 * torch.randn((D,), generator=g, device=device)
        args = (x, y, b, scale, bias, eps)
        (x_new, h), (x_want, h_want) = (ln_ops.add_layer_norm(*args),
                                        ln_ops.add_layer_norm_reference(*args))
        torch.cuda.synchronize()
        abs_err, apart = _step_errors(h, h_want)
        s16, b16 = scale.to(bf16), bias.to(bf16)
        ms = time_cuda(lambda: ln_ops.add_layer_norm(*args))
        plain_ms = time_cuda(lambda: ln_ops.add_layer_norm_reference(*args))
        lib_ms = time_cuda(lambda: F.layer_norm(x + (y + b), (D,), s16, b16, eps))
        b_ms, b_by = bound(12.0 * B * D, 8.0 * B * D + 10.0 * D, PEAK_FP32_FLOPS)
        case = f"{model} B={B}"
        print(f"K14 add_layer_norm {case} [{B}, 1, {D}] bf16, bias bf16, fp32 scale and bias: "
              f"x_new {'bit-equal' if torch.equal(x_new, x_want) else 'DIFFERS'}, h "
              f"max_abs_err {abs_err:.3e}, {apart} values over one bf16 step | kernel "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms library (bf16 adds + F.layer_norm) "
              f"{lib_ms:.4f} ms | bound {b_ms:.5f} ms ({b_by}) = {100 * b_ms / ms:.1f}% | "
              f"ptxas {ptxas_of('add_ln_kernel')}")
        if apart or not torch.equal(x_new, x_want):
            fail(f"K14 ({case}) disagrees with its plain version")
        k14[case] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms)
    k14["attribution"] = k14_attribution(device)
    return [dict(name="add_layer_norm", route="cuda", source="sar_tpu_torch/csrc/layer_norm.cu",
                 replaces="none: XLA fuses the jnp adds and LayerNorm",
                 **k14["whisper-small B=128"],
                 extra={k: v for k, v in k14.items() if k != "whisper-small B=128"})]


def k14_attribution(device) -> dict:
    """The device ops of one eager whisper-small decode step at batch
    K14_STEP_BATCH (random bf16 weights, one encoder layer: the cache is
    built from a random encoder output), under torch.profiler, by kernel
    name (cut to 64 characters, as the benchmark's breakdown names them):
    the step with the plain LayerNorm chain, the boundary chain alone (the
    first LayerNorm and the 3L sublayer boundaries, each the plain chain),
    and the step with K13 and K14. Prints and returns ms per step by name."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.models.config import get_config
    from sar_tpu_torch.ops import layer_norm as ln_ops

    cfg = dataclasses.replace(get_config(MODEL), encoder_layers=1)
    g = torch.Generator(device=device).manual_seed(SEED + 15)
    params = whisper.cast_params(whisper.init_params(cfg, g, device), torch.bfloat16)
    B, L, D = K14_STEP_BATCH, cfg.decoder_layers, cfg.d_model
    enc = torch.randn((B, cfg.max_source_positions, D), generator=g,
                      device=device).to(torch.bfloat16)
    cache = whisper.init_cache(params, enc, cfg, 32, cross_kv_int8=True, self_kv_int8=True)
    tok = torch.arange(B, device=device) + 100
    x = torch.randn((B, 1, D), generator=g, device=device).to(torch.bfloat16)
    lns = params["decoder"]["layers"]["self_ln"]
    b = params["decoder"]["layers"]["fc2"]["b"][0]

    def chain():
        ln_ops.layer_norm_reference(x, lns["scale"][0], lns["bias"][0], cfg.ln_eps)
        for _ in range(3 * L):
            ln_ops.add_layer_norm_reference(x, x, b, lns["scale"][0], lns["bias"][0], cfg.ln_eps)

    def profiled(fn, runs=3):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n = e.name[:64]
                by_name[n] = by_name.get(n, 0.0) + e.time_range.elapsed_us() / 1e3 / runs
        return by_name

    takes = ln_ops.kernel_takes
    ln_ops.kernel_takes = lambda D: False          # the step's plain route
    try:
        plain = profiled(lambda: whisper.decode_step(params, tok, 5, cache, cfg))
    finally:
        ln_ops.kernel_takes = takes
    fused = profiled(lambda: whisper.decode_step(params, tok, 5, cache, cfg))
    boundary = profiled(chain)
    out = {"plain step": plain, "boundary chain": boundary, "k13/k14 step": fused}
    names = sorted(set(plain) | set(fused), key=lambda n: -max(plain.get(n, 0), fused.get(n, 0)))
    print(f"K14 attribution, one eager {MODEL} decode step at B={B} (device ms per step: "
          f"plain step | its boundary chain | the step with K13/K14):")
    for n in names[:16]:
        print(f"  {n}: {plain.get(n, 0.0):.4f} | {boundary.get(n, 0.0):.4f} | "
              f"{fused.get(n, 0.0):.4f}")
    print(f"  total: {sum(plain.values()):.4f} | {sum(boundary.values()):.4f} | "
          f"{sum(fused.values()):.4f}")
    return out


def build_k3_probes(work: Path):
    """nvcc K3_PROBE_SRC into a shared library in `work` and load it."""
    import ctypes
    from sar_tpu_torch.ops import _build
    src, lib = work / "k3_probe.cu", work / "libk3_probe.so"
    src.write_text(K3_PROBE_SRC)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True, timeout=600)
    probe = ctypes.CDLL(str(lib)).k3_probe
    probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    probe.restype = ctypes.c_int
    return probe


def k3_attribution(device, B: int, H: int, S_pad: int, L: int, work: Path) -> dict:
    """K3 at [B, H, S_pad] over an L-layer int8 cache (scale 0 past 1500
    rows, as whisper's padding), in its cluster form and, where the rule
    takes it, its large-batch form, against the K3_PROBES, each per call
    over an L-layer sweep, as the decode loop calls it; prints one line
    and returns {name: ms} with the bytes and the cluster form's I2F
    conversions."""
    import torch
    from sar_tpu_torch.ops import _build, decode_cross
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    D = H * 64
    kq = torch.randint(-127, 128, (L, B, S_pad, D), generator=g, device=device, dtype=torch.int8)
    vq = torch.randint(-127, 128, (L, B, S_pad, D), generator=g, device=device, dtype=torch.int8)
    ks = torch.rand((L, B, H, S_pad), generator=g, device=device) * 0.01 + 1e-4
    vs = torch.rand((L, B, H, S_pad), generator=g, device=device) * 0.01 + 1e-4
    ks[..., min(S_pad, 1500):] = 0
    q = (torch.randn((B, D), generator=g, device=device) * 0.125).to(torch.bfloat16)
    probe = build_k3_probes(work)
    C, slice_rows = decode_cross.cluster_split(S_pad)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = torch.zeros(max(C * H * B, 8 * sms) * 8, dtype=torch.int32, device=device)
    forms = {"K3 (cluster form)": 0}
    if decode_cross.stream_heads(B, H, S_pad, _build.sm_count(device)):
        forms["K3 (large-batch form)"] = 1
    ms = {name: time_cuda(lambda form=form: [decode_cross.cross_decode_exact_form(
        q, kq, ks, vq, vs, layer=layer, n_heads=H, form=form) for layer in range(L)]) / L
        for name, form in forms.items()}
    for kind, name in enumerate(K3_PROBES):
        def run(kind=kind):
            stream = torch.cuda.current_stream(device).cuda_stream
            for layer in range(L):
                code = probe(kind, kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
                             out.data_ptr(), L, B, S_pad, D, H, layer, C, slice_rows, 8 * sms,
                             stream)
                if code:
                    fail(f"K3 probe {name}: cudaError {code}")
        ms[name] = time_cuda(run) / L
    nbytes = 2 * B * S_pad * D + 2 * 4 * B * H * S_pad
    conv = 2 * B * S_pad * D
    parts = " | ".join(f"{n} {t:.4f} ms = {nbytes / 1e6 / t:.0f} GB/s" for n, t in ms.items())
    print(f"K3 attribution [B={B}, H={H}, S_pad={S_pad}, D={D}, all {L} layers, "
          f"{nbytes / 1e6:.1f} MB a call, bound {1e3 * nbytes / PEAK_HBM_BYTES:.4f} ms]: {parts}"
          f" | the cluster form converts {conv / 1e6:.0f} M int8 values a call by I2F: at 16 a clock per SM "
          f"that is {1e3 * conv / (16 * sms * 1.98e9):.4f} ms at 1.98 GHz")
    del kq, vq, ks, vs
    return dict(ms=ms, bytes=nbytes, conversions=conv)


def phase_k3_large(cfg, device) -> dict:
    """K3 at the evaluation cells' batch: the attribution line at
    whisper-small B=K3_BIG_BATCH; then at whisper-small's and at OWSM v4
    medium's cross shapes (K3_BIG_SHAPES) both forms (the cluster form and
    the large-batch form, through decode_cross.cross_decode_exact_form) and
    the wrapper against the plain version on the first and last layer, two
    runs of each form bit for bit, each timed per call over an L-layer
    sweep beside the plain version, with GB/s and the bound (the valid
    rows' int8 and scales, q and the output, over the HBM rate); last,
    the captured greedy loop at whisper-small B=K3_BIG_BATCH (random
    weights and encoder output, K3_BIG_TOKENS new tokens, the first batch
    captured, the second replayed): K3 12 per step run, every launch in
    the large-batch form. -> the readings, for the K3 row's extra."""
    import torch
    from sar_tpu_torch.decode.graphs import CudaGraphCapture, DecodeRunner
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.ops import _build, decode_cross

    g = torch.Generator(device=device).manual_seed(SEED + 24)
    sms = _build.sm_count(device)
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch, prefix="k3_probe_") as work:
        attribution = k3_attribution(device, K3_BIG_BATCH, cfg.decoder_heads,
                                     whisper.cross_pad_len(cfg.max_source_positions),
                                     cfg.decoder_layers, Path(work))
    readings = {"attribution": attribution}
    for label, (H, S, S_pad, L) in K3_BIG_SHAPES.items():
        B, D = K3_BIG_BATCH, H * 64
        kq = torch.randint(-127, 128, (L, B, S_pad, D), generator=g, device=device,
                           dtype=torch.int8)
        vq = torch.randint(-127, 128, (L, B, S_pad, D), generator=g, device=device,
                           dtype=torch.int8)
        ks = torch.rand((L, B, H, S_pad), generator=g, device=device) * 0.01 + 1e-4
        vs = torch.rand((L, B, H, S_pad), generator=g, device=device) * 0.01 + 1e-4
        ks[..., S:] = 0
        vs[..., S:] = 0
        q = (torch.randn((B, D), generator=g, device=device) * 0.125).to(torch.bfloat16)
        G = decode_cross.stream_heads(B, H, S_pad, sms)
        if G == 0 or decode_cross.launched_form(B, H, S_pad, device) != G:
            fail(f"K3 at {label} B={B}: the rule takes form {G}, the library "
                 f"{decode_cross.launched_form(B, H, S_pad, device)}; want the large-batch form")
        err = 0.0
        for layer in (0, L - 1):
            want = decode_cross.cross_decode_reference_exact(q, kq, ks, vq, vs, layer=layer,
                                                             n_heads=H)
            got = decode_cross.cross_decode_attention_exact(q, kq, ks, vq, vs, layer=layer,
                                                            n_heads=H)
            for form in (0, 1):
                one, again = (decode_cross.cross_decode_exact_form(
                    q, kq, ks, vq, vs, layer=layer, n_heads=H, form=form) for _ in range(2))
                a, rr = _attn_errors(one, want)
                if a > ATTN_ABS_TOL or rr > ATTN_REL_TOL or not torch.equal(one, again):
                    fail(f"K3 form {form} at {label} B={B}: max_abs_err {a:.3e}, "
                         f"bits equal {torch.equal(one, again)}")
                err = max(err, a)
            if not torch.equal(got, one):
                fail(f"K3 at {label} B={B}: the wrapper's output is not its large-batch form's")
        torch.cuda.synchronize()

        def sweep(fn, **kw):
            return lambda: [fn(q, kq, ks, vq, vs, layer=layer, n_heads=H, **kw)
                            for layer in range(L)]
        ms = {form: time_cuda(sweep(decode_cross.cross_decode_exact_form, form=form)) / L
              for form in (0, 1)}
        plain_ms = time_cuda(sweep(decode_cross.cross_decode_reference_exact)) / L
        nbytes = 2 * B * S_pad * D + 8 * B * H * S_pad
        b_ms, b_by = bound(4.0 * B * S * D, 2 * B * S * D + 8 * B * H * S + 4 * B * D)
        print(f"K3 at {label} [B={B}, H={H}, S_pad={S_pad} ({S} valid), D={D}, all {L} layers]: "
              f"max_abs_err {err:.3e} (tol {ATTN_ABS_TOL}), each form bit-stable | per call: "
              f"cluster form {ms[0]:.4f} ms = {nbytes / 1e6 / ms[0]:.0f} GB/s "
              f"({100 * b_ms / ms[0]:.1f}% of bound), large-batch form {ms[1]:.4f} ms = "
              f"{nbytes / 1e6 / ms[1]:.0f} GB/s ({100 * b_ms / ms[1]:.1f}%), plain "
              f"{plain_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by}) | ptxas "
              f"{ptxas_of('cross_decode_exact_kernel_stream')}")
        readings[label] = dict(max_abs_err=err, cluster_ms=ms[0], stream_ms=ms[1],
                               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                               gbps=nbytes / 1e6 / ms[1])
        del kq, vq, ks, vs

    # The captured greedy loop at the evaluation batch.
    params = whisper.cast_params(whisper.init_params(cfg, g, device), torch.bfloat16)
    enc = (torch.randn((K3_BIG_BATCH, cfg.max_source_positions, cfg.d_model), generator=g,
                       device=device) * 0.5).to(torch.bfloat16)
    prompt = cfg.prompt_ids("hindi")
    total = len(prompt) + K3_BIG_TOKENS
    run = DecodeRunner(params, cfg, capture=CudaGraphCapture)
    for label in ("captured", "replayed"):
        reset_counts()
        run.greedy(run.prep(enc, total, **INT8), prompt)
        torch.cuda.synchronize()
        counts, steps = read_counts(), read_steps()["greedy"]
        if counts["cross_decode_attention_exact"] != cfg.decoder_layers * steps:
            fail(f"K3 at B={K3_BIG_BATCH} ({label}): {counts['cross_decode_attention_exact']} "
                 f"launches for {steps} steps")
        check_k3_form(f"K3 greedy loop ({label}, {steps} steps)", counts, K3_BIG_BATCH,
                      cfg.decoder_heads, whisper.cross_pad_len(cfg.max_source_positions))
    readings["loop_launches"] = counts["cross_decode_attention_exact"]
    del params, enc, run
    return readings


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
        flops = {"flash_attention_fwd": 4 * f, "flash_attention_bwd_dq": 6 * f,
                 "flash_attention_bwd_dkv": 8 * f}
        line = []
        for name, (kern, plain) in fns.items():
            a, b = kern(), plain()
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            err = max(_attn_errors(x, y)[1] for x, y in zip(a, b))
            abs_err = max(_attn_errors(x, y)[0] for x, y in zip(a, b))
            if name == "flash_attention_fwd":
                rule = f"rel err {err:.2e}, tol {K6_FWD_REL_TOL}"
                if err > K6_FWD_REL_TOL:
                    fail(f"K6 {name} ({label}) disagrees with its plain version: {rule}")
            else:
                excess, fro = (max(e) for e in zip(*(_bwd_errors(x, y) for x, y in zip(a, b))))
                rule = (f"rel err {err:.2e}, per entry beyond 1 bf16 ulp {excess:.2e} of the "
                        f"largest (tol {K6_BWD_FLOOR}), Frobenius {fro:.2e} (tol {K6_BWD_FRO_TOL})")
                if excess > K6_BWD_FLOOR or fro > K6_BWD_FRO_TOL:
                    fail(f"K6 {name} ({label}) disagrees with its plain version: {rule}")
            del a, b
            ms, plain_ms = time_cuda(kern), time_cuda(plain)
            b_ms, b_by = bounds[name]
            per[name][label] = dict(max_abs_err=abs_err, max_rel_err=err, ms=ms, plain_ms=plain_ms,
                                    tflops=flops[name] / ms / 1e9,
                                    bound_ms=b_ms, bound_by=b_by,
                                    library_ms=lib["fwd" if name == "flash_attention_fwd"
                                                   else "fwd+bwd"])
            line.append(f"{name[16:]} {ms:.3f} ms = {flops[name] / ms / 1e9:.1f} TFLOP/s (plain "
                        f"{plain_ms:.3f}, bound {b_ms:.4f} {b_by}, {rule})")
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


def _kv_gemms(x, wk, wv, bv, va=None, vb=None, lora_scale=1.0):
    """K2/K4's products as bf16 cuBLAS calls, per layer: x.Wk, x.Wv + bv
    (and, with va/vb, u = x.va and V + lora_scale * u.vb). The yardstick's
    first half; the port never calls it."""
    import torch
    B, S_pad, D = x.shape
    x2 = x.reshape(B * S_pad, D)
    out = []
    for l in range(wk.shape[0]):
        k = x2 @ wk[l]
        v = torch.addmm(bv[l], x2, wv[l])
        if va is not None:
            u = torch.bmm(x, va[l].expand(B, -1, -1))
            v = v + lora_scale * torch.bmm(u, vb[l].expand(B, -1, -1)).reshape(B * S_pad, D)
        out.append((k.view(B, S_pad, D), v.view(B, S_pad, D)))
    return out


def _kv_library(x, wk, wv, bv, n_heads, t_valid, va=None, vb=None, lora_scale=1.0):
    """The library yardstick of K2/K4: `_kv_gemms`, then the torch
    quantize_rows of every layer's K and V."""
    from sar_tpu_torch.ops import kv_init
    return [(kv_init.quantize_rows(k, n_heads, t_valid), kv_init.quantize_rows(v, n_heads, t_valid))
            for k, v in _kv_gemms(x, wk, wv, bv, va, vb, lora_scale)]


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


def decode_steps(tokens, cfg, prompt_len: int, segment: int = 32) -> tuple[int, int]:
    """(steps needed, steps run) of a greedy batch's tokens: the loop needs
    the steps up to the one after which every row has emitted EOS after the
    prompt (or total - 1), and runs on to the end of the segment that holds
    that step, where the host asks whether to stop (decode/segments.py)."""
    from sar_tpu_torch.decode.segments import grid
    total = tokens.shape[1]
    gen = tokens[:, prompt_len:] == cfg.eos_token_id
    needed = total - 1
    if bool(gen.any(1).all()):
        needed = min(int((gen.int().argmax(1) + prompt_len).max()), total - 1)
    run = next(hi for lo, hi, _ in grid(total, segment) if lo < needed <= hi)
    return needed, run


def segments_run(total: int, steps_run: int, segment: int = 32) -> int:
    """The segments (= host syncs) of a loop that ran `steps_run` steps."""
    from sar_tpu_torch.decode.segments import grid
    return sum(lo < steps_run for lo, _, _ in grid(total, segment))


K6_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
K7_NAMES = ("cross_decode_attention", "cross_decode_attention_beam")
# K8 runs on the fq path only; K9 and K10 have no caller in either package
# (checked and timed in phase_kernels_k8_k10, launched on no path).
OFF_PATH = ("encoder_attention_fused", "self_decode_attention", "decode_attention")
KERNEL_NAMES = ("encoder_attention_hm", "fused_kv_init", "fused_kv_init_lora",
                "cross_decode_attention_exact", "cross_decode_attention_exact_beam",
                *K6_NAMES, *K7_NAMES, *OFF_PATH)
# K11 (the int8 self-attention decode) is counted on every path and held
# to its count by check_k11 in the greedy, routed, beam and mixed phases;
# check_counts keeps to KERNEL_NAMES.
K11_NAME = "self_decode_attention_exact"
# K12 runs in OWSM's encoder only: counted on every path, held to its
# count in the owsm phase.
OWSM_NAMES = ("depthwise_conv_time",)
# K13 (once) and K14 (3 per layer) run in every decoder step over bf16 rows
# of a width they take, every path's at whisper-small and OWSM, and K13 in
# OWSM's encoder too: counted on every path, held by check_ln to the steps
# run in the greedy, mixed and owsm phases.
LN_NAMES = ("layer_norm", "add_layer_norm")
# K3's launches in its large-batch form (decode_cross.STREAM_LAUNCHES):
# counted on every path, held by check_k3_form to the rule's count.
K3_STREAM_NAME = "cross_decode_attention_exact_stream"
COUNTED_NAMES = (*KERNEL_NAMES, K11_NAME, *OWSM_NAMES, *LN_NAMES, K3_STREAM_NAME)
INT8 = dict(cross_kv_int8=True, self_kv_int8=True)   # the int8 head-minor cache


def reset_counts():
    """Every kernel's launch counter, the decode steps by path and the
    decode loops' host syncs to 0."""
    from sar_tpu_torch.decode import segments
    from sar_tpu_torch.ops import (decode_cross, decode_self_exact, dwconv, flash, flash_enc,
                                   kv_init, layer_norm)
    from sar_tpu_torch.ops.attic import attention, decode_self
    segments.STEPS.update(dict.fromkeys(segments.STEPS, 0))
    segments.HOST_SYNCS = 0
    decode_self_exact.LAUNCHES = dwconv.LAUNCHES = 0
    layer_norm.LAUNCHES = layer_norm.ADD_LAUNCHES = 0
    flash_enc.LAUNCHES = flash_enc.FUSED_LAUNCHES = 0
    kv_init.LAUNCHES = kv_init.LORA_LAUNCHES = 0
    decode_cross.LAUNCHES = decode_cross.BEAM_LAUNCHES = decode_cross.STREAM_LAUNCHES = 0
    decode_cross.S8_LAUNCHES = decode_cross.S8_BEAM_LAUNCHES = 0
    flash.LAUNCHES = flash.DQ_LAUNCHES = flash.DKV_LAUNCHES = 0
    decode_self.LAUNCHES = attention.LAUNCHES = 0


def read_counts() -> dict:
    from sar_tpu_torch.ops import (decode_cross, decode_self_exact, dwconv, flash, flash_enc,
                                   kv_init, layer_norm)
    from sar_tpu_torch.ops.attic import attention, decode_self
    return dict(zip(COUNTED_NAMES, (flash_enc.LAUNCHES, kv_init.LAUNCHES,
                                   kv_init.LORA_LAUNCHES, decode_cross.LAUNCHES,
                                   decode_cross.BEAM_LAUNCHES, flash.LAUNCHES,
                                   flash.DQ_LAUNCHES, flash.DKV_LAUNCHES,
                                   decode_cross.S8_LAUNCHES,
                                   decode_cross.S8_BEAM_LAUNCHES,
                                   flash_enc.FUSED_LAUNCHES, decode_self.LAUNCHES,
                                   attention.LAUNCHES, decode_self_exact.LAUNCHES,
                                   dwconv.LAUNCHES, layer_norm.LAUNCHES,
                                   layer_norm.ADD_LAUNCHES, decode_cross.STREAM_LAUNCHES)))


def read_steps() -> dict:
    """Decode steps run by path (greedy, beam and s8 over the head-minor
    cache, classic over the others) and the decode loops' host syncs, as
    counted since reset_counts, captured replays included."""
    from sar_tpu_torch.decode import segments
    return {**segments.STEPS, "host_syncs": segments.HOST_SYNCS}


def check_counts(path: str, counts: dict, want_zero: tuple) -> None:
    """Every kernel of the path launched, and none that is not on it."""
    missing = [k for k in KERNEL_NAMES if k not in want_zero and counts[k] == 0]
    if missing:
        fail(f"the {path} path launched no {', '.join(missing)} kernel")
    extra = [k for k in want_zero if counts[k] != 0]
    if extra:
        fail(f"the {path} path launched {', '.join(extra)}, which is not on it")


def check_k3_form(path: str, counts: dict, B: int, H: int, S_pad: int) -> None:
    """K3's launches in its large-batch form: all of them where the rule
    (decode_cross.stream_heads) takes it at [B, H, S_pad] on this card,
    else none."""
    import torch
    from sar_tpu_torch.ops import _build, decode_cross
    k3 = counts["cross_decode_attention_exact"]
    large = decode_cross.stream_heads(B, H, S_pad, _build.sm_count(torch.device("cuda", 0))) > 0
    print(f"{path}: K3 launched {k3} times at B={B}, H={H}, S_pad={S_pad}, "
          f"{counts[K3_STREAM_NAME]} in its large-batch form (the rule: {k3 if large else 0})")
    if counts[K3_STREAM_NAME] != (k3 if large else 0):
        fail(f"{path}: K3's large-batch form launched {counts[K3_STREAM_NAME]} times, "
             f"the rule {k3 if large else 0}")


def check_k11(path: str, counts: dict, want: int) -> None:
    """K11 launched `want` times on `path`: once per layer of every step
    over a classic int8 self side without scores_int8 or ancestry, else 0."""
    print(f"{path}: K11 {K11_NAME} launched {counts[K11_NAME]} times (the design: {want})")
    if counts[K11_NAME] != want:
        fail(f"{path}: K11 launched {counts[K11_NAME]} times, not {want}")


def check_ln(path: str, counts: dict, layers: int, steps: int, encoder_k13: int = 0) -> None:
    """K13 once and K14 3 x `layers` times in each of `steps` decoder steps
    (plus `encoder_k13` K13 launches of OWSM's encoder)."""
    want = (steps + encoder_k13, 3 * layers * steps)
    got = tuple(counts[k] for k in LN_NAMES)
    print(f"{path}: K13, K14 launched {list(got)} times in {steps} steps (the design: "
          f"{list(want)})")
    if got != want:
        fail(f"{path}: K13, K14 launched {list(got)} times, not {list(want)}")


def check_steps(path: str, counts: dict, steps: dict, want_steps: int, want_syncs: int,
                kernel: str | None, layers: int, key: str = "greedy") -> None:
    """The decode steps run on `path` (by the step counters, replays
    included) are those its tokens predict, the host synced once per
    segment, and `kernel` launched once per layer of every step run."""
    if steps[key] != want_steps or steps["host_syncs"] != want_syncs:
        fail(f"{path}: {steps[key]} {key} steps and {steps['host_syncs']} host syncs run, "
             f"the tokens predict {want_steps} and {want_syncs}")
    if kernel is not None and counts[kernel] != layers * steps[key]:
        fail(f"{path}: {kernel} launched {counts[kernel]} times in {steps[key]} steps, "
             f"not {layers} per step")


def check_captured_equals_eager(path: str, captured, eager) -> None:
    """The captured decode's tokens equal the eager loop's on one batch."""
    same = bool((captured == eager).all())
    print(f"{path}: captured tokens {'equal' if same else 'DIFFER FROM'} the eager loop's "
          f"(batch of {captured.shape[0]}, {captured.shape[1]} positions)")
    if not same:
        fail(f"{path}: the captured decode's tokens differ from the eager loop's")


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

    # Warm-up batch (the capture of the segments it reaches, cuBLAS
    # handles, allocator), not counted: the counted batches replay.
    run(ev, audio[0])
    if not ev.capture:
        fail("the evaluator does not capture its decode loop on the card")
    reset_counts()
    outs, wall, syncs = [], 0.0, 0
    for i, a in enumerate(audio):
        t_b = time.perf_counter()
        tokens, (t_mel, t_prep, t_dec) = run(ev, a)
        dt = time.perf_counter() - t_b
        wall += dt
        needed, steps = decode_steps(tokens, cfg, P)
        syncs += segments_run(ev.total, steps)
        if tokens.shape != (batch, ev.total) or tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
            fail(f"batch {i}: bad token tensor {tuple(tokens.shape)}")
        print(f"e2e batch {i}: wall {dt * 1e3:.1f} ms (mel {t_mel * 1e3:.1f}, "
              f"prep {t_prep * 1e3:.1f}, decode {t_dec * 1e3:.1f} ms for {steps} steps run "
              f"({needed} needed) = {t_dec * 1e3 / steps:.3f} ms/token-step at batch {batch})")
        outs.append((tokens, steps, t_dec))
    counts, run_steps = read_counts(), read_steps()
    audio_s = n_batches * batch * mel_ops.CHUNK_SECONDS
    ms_tok = 1e3 * sum(o[2] for o in outs) / sum(o[1] for o in outs)
    print(f"e2e (captured): {audio_s} audio-s in {wall:.3f} s -> RTFx {audio_s / wall:.1f} | "
          f"{ms_tok:.3f} ms/token-step (batch {batch}) | steps {json.dumps(run_steps)} | "
          f"launches {json.dumps(counts)}")
    check_counts("greedy", counts, want_zero=("fused_kv_init_lora",
                                              "cross_decode_attention_exact_beam", *K6_NAMES,
                                              *K7_NAMES, *OFF_PATH))
    check_steps("greedy", counts, run_steps, sum(o[1] for o in outs), syncs,
                "cross_decode_attention_exact", cfg.decoder_layers)
    check_k11("greedy", counts, cfg.decoder_layers * run_steps["greedy"])
    check_ln("greedy", counts, cfg.decoder_layers, run_steps["greedy"])
    check_k3_form("greedy", counts, batch, cfg.decoder_heads,
                  whisper.cross_pad_len(cfg.max_source_positions))
    # The captured loop against the eager one on the replayed batch 0.
    eager = ASREvaluator(cfg, params, language=language, max_new_tokens=max_new_tokens,
                         device=device, capture=False)
    check_captured_equals_eager("greedy", outs[0][0], run(eager, audio[0])[0])

    # Lockstep: both paths fed the kernel path's tokens, argmax compared at
    # every generated position; then the plain path free-running.
    plain = ASREvaluator(cfg, params, language=language, max_new_tokens=max_new_tokens,
                         device=device, flash=False, kernels=False)
    tok_k = outs[0][0]
    steps = decode_steps(tok_k, cfg, P)[0]
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
    steps, steps_run = decode_steps(tok_k, cfg, router.prompt_len)
    counts, run_steps = read_counts(), read_steps()
    if tok_k.shape != (batch, router.prompt_len + max_new_tokens) or tok_k.min() < 0 \
            or tok_k.max() >= cfg.vocab_size:
        fail(f"routed generate: bad token tensor {tuple(tok_k.shape)}")
    print(f"routed generate, adapters {MIXED_ADAPTERS[:batch]}: adapted encode "
          f"{t_enc * 1e3:.1f} ms, cache (K4) {t_cache * 1e3:.1f} ms, decode "
          f"{t_dec * 1e3:.1f} ms for {steps_run} steps run ({steps} needed) = "
          f"{t_dec * 1e3 / steps_run:.3f} ms/token-step at batch {batch} (captured)")
    print(f"routed steps {json.dumps(run_steps)} | launches {json.dumps(counts)}")
    check_counts("routed", counts, want_zero=("fused_kv_init",
                                              "cross_decode_attention_exact_beam", *K6_NAMES,
                                              *K7_NAMES, *OFF_PATH))
    # The service's batches and the mixed one: K3 once per layer of every
    # step run, replays included, and at least one host sync per batch.
    if (counts["cross_decode_attention_exact"] != cfg.decoder_layers * run_steps["greedy"]
            or run_steps["host_syncs"] < st["batches"] + 1):
        fail(f"routed: K3 {counts['cross_decode_attention_exact']} for "
             f"{run_steps['greedy']} steps, {run_steps['host_syncs']} host syncs for "
             f"{st['batches'] + 1} batches")
    check_k11("routed", counts, cfg.decoder_layers * run_steps["greedy"])
    eager = AdapterRouter(cfg, params, bank, lcfg, router.clf_params, ccfg, device=device,
                          capture=False)
    check_captured_equals_eager("routed", tok_k, eager.decode(eager.encode(feats, idx), idx,
                                                              max_new_tokens))
    del eager

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
    ev.tokens(feats)                                   # warm-up batch (capture), not counted
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    res = ev.evaluate(loader, return_predictions=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, run_steps = read_counts(), read_steps()
    steps = [run_steps["beam"]]
    if res["num_samples"] != BEAM_ITEMS or not all(
            np.isfinite(res[m]) and res[m] >= 0 for m in ("wer", "cer")):
        fail(f"beam evaluate: bad result {({k: res[k] for k in ('wer', 'cer', 'num_samples')})}")
    audio_s = BEAM_ITEMS * mel_ops.CHUNK_SECONDS         # one 30 s window per item
    print(f"beam evaluate: WER {res['wer']:.4f} CER {res['cer']:.4f} over "
          f"{res['num_samples']} items (random weights: the path, not the accuracy) | "
          f"{audio_s:.0f} audio-s in {wall:.3f} s -> RTFx {audio_s / wall:.1f} | "
          f"{steps[0]} decode steps run (captured), {run_steps['host_syncs']} host syncs | "
          f"launches {json.dumps(counts)}")
    check_counts("beam", counts, want_zero=("fused_kv_init_lora",
                                            "cross_decode_attention_exact", *K6_NAMES,
                                            *K7_NAMES, *OFF_PATH))
    if counts["cross_decode_attention_exact_beam"] != steps[0] * cfg.decoder_layers:
        fail("K5 was not launched once per layer of every beam decode step")
    check_k11("beam (the self cache read through the ancestry)", counts, 0)

    # The first batch fenced: encoder, then beam_decode (cache + loop).
    def fenced(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    enc, t_enc = fenced(lambda: ev.encode(feats))
    reset_counts()
    tok_k, t_dec = fenced(lambda: ev.beam(feats))
    n_steps = read_steps()["beam"]
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
    eager = ASREvaluator(cfg, params, CharTokenizer(cfg), language="english",
                         max_new_tokens=max_new_tokens, num_beams=K, device=device,
                         capture=False)
    check_captured_equals_eager("beam", tok_k, eager.tokens(feats))
    del eager
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

    def counted(fn, key):
        """fn() with the launch and step counters zeroed before and read
        after: (out, counts, `key` steps run, wall seconds)."""
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, read_counts(), read_steps()[key], wall

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
    outs, c_greedy, n_steps, wall = counted(lambda: greedy(ev, audio), "s8")
    for i, (tokens, _) in enumerate(outs):
        check_tokens(f"s8 greedy batch {i}", tokens, ev.total)
    audio_s = n_batches * batch * mel_ops.CHUNK_SECONDS
    ms_tok = 1e3 * sum(t for _, t in outs) / n_steps
    print(f"s8 greedy: {audio_s} audio-s in {wall:.3f} s -> RTFx {audio_s / wall:.1f} | "
          f"{ms_tok:.3f} ms/token-step (batch {batch}, {n_steps} decode steps) | launches "
          f"{json.dumps(c_greedy)}")
    check_counts("s8 greedy", c_greedy,
                 want_zero=tuple(k for k in others if k != "cross_decode_attention"))
    check_k11("s8 greedy (scores_int8)", c_greedy, 0)
    if c_greedy["cross_decode_attention"] != L * n_steps:
        fail(f"s8 greedy: K7 launched {c_greedy['cross_decode_attention']} times in "
             f"{n_steps} decode steps, not {L} per step")

    # Lockstep against the plain path (kernels=False, exact encoder), both
    # fed the kernel path's tokens; then the gate's readings against the
    # exact-scores path on the same batch.
    plain = ASREvaluator(cfg, params, scores_int8=True, flash=False, kernels=False, **kw)
    exact = ASREvaluator(cfg, params, capture=False, **kw)        # the gate's reference
    tok_k = outs[0][0]
    f0 = mel(audio[0])
    lock_steps = decode_steps(tok_k, cfg, P)[0]
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
    eager = ASREvaluator(cfg, params, scores_int8=True, capture=False, **kw)
    check_captured_equals_eager("s8 greedy", tok_k, eager.dec(eager.prep(f0)))
    del eager
    if profile:
        step = lambda tok, pos, c: whisper.decode_step(params, tok, pos, c, cfg, scores_int8=True)
        profile_steps("s8 greedy", step, ev.prep(f0), tok_k, P)

    # Beams: one batch of `batch` samples x K beams, K7 beam-folded.
    ev_b = ASREvaluator(cfg, params, scores_int8=True, num_beams=K, **kw)
    ev_b.tokens(f0)                                                # warm-up (capture)
    tok_b, c_beam, n_beam, wall_b = counted(lambda: ev_b.tokens(f0), "s8")
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
    check_k11("s8 beam (scores_int8)", c_beam, 0)
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
    eager = ASREvaluator(cfg, params, scores_int8=True, num_beams=K, capture=False, **kw)
    check_captured_equals_eager("s8 beam", tok_b, eager.tokens(f0))
    del eager

    # int4: one greedy batch over the nibble-packed cache (plain torch; the
    # encoder is K1's), against the exact int8 path's tokens.
    ev4 = ASREvaluator(cfg, params, kv_int4=True, **kw)
    greedy(ev4, audio[:1])                                         # warm-up (capture)
    out4, c_int4, n4, _ = counted(lambda: greedy(ev4, audio[:1]), "classic")
    tok4, t4 = out4[0]
    check_tokens("int4 greedy", tok4, ev4.total)
    check_counts("int4 greedy", c_int4, want_zero=(*others, "fused_kv_init"))
    print(f"int4 greedy (batch 0): {1e3 * t4 / n4:.3f} ms/token-step over {n4} steps | "
          f"against the exact int8 path: rows equal "
          f"{(tok4 == tok_x).all(1).float().mean().item():.4f}, tokens equal "
          f"{(tok4[:, P:] == tok_x[:, P:]).float().mean().item():.4f} | launches "
          f"{json.dumps(c_int4)}")
    return {k: c_greedy[k] + c_beam[k] + c_int4[k] for k in COUNTED_NAMES}


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


def profile_loop(label, ev, feats, n_steps):
    """One greedy loop of evaluator `ev` over `feats` (its prep unprofiled)
    under torch.profiler; printed per step run."""
    import torch
    from torch.profiler import ProfilerActivity
    cache = ev.prep(feats)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev.dec(cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print_profile(label, prof, wall_ms, n_steps, top_k=8)


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


def k8_projection_half(args, x, p, lns, lnb, batch, T, D, H, S):
    """K8's LN + projection half alone (encoder_ln_qkv) against its plain
    version's q/k/v planes, with its bound and the library's LN + three
    addmm (cuBLAS) as the yardstick. Returns its numbers, or None on a
    tree without the entry point (an older checkout run for comparison)."""
    import torch
    import torch.nn.functional as F
    from sar_tpu_torch.ops import flash_enc
    if not hasattr(flash_enc, "encoder_ln_qkv"):
        print("K8 projection half: this tree has no entry point for it")
        return None
    got = flash_enc.encoder_ln_qkv(*args, n_heads=H)
    want = flash_enc.encoder_ln_qkv_reference(*args, n_heads=H)
    torch.cuda.synchronize()
    excess = max(_bwd_errors(a[:, :S], b[:, :S])[0] for a, b in zip(got, want))
    abs_err = (got[:, :, :S].float() - want[:, :, :S].float()).abs().max().item()
    scaling = (D // H) ** -0.5

    def library():
        """F.layer_norm and three addmm (q's bias and scaling in its call)."""
        h = F.layer_norm(x, (D,), lns, lnb, eps=1e-5).view(-1, D)
        return (torch.addmm(p["q"]["b"], h, p["q"]["w"], beta=scaling, alpha=scaling),
                torch.mm(h, p["k"]["w"]), torch.addmm(p["v"]["b"], h, p["v"]["w"]))
    lib_err = max((a.view(batch, T, D)[:, :S].float() - b[:, :S].float()).abs().max().item()
                  for a, b in zip(library(), want))
    ms = time_cuda(lambda: flash_enc.encoder_ln_qkv(*args, n_heads=H))
    plain_ms = time_cuda(lambda: flash_enc.encoder_ln_qkv_reference(*args, n_heads=H))
    library_ms = time_cuda(library)
    b_ms, b_by = bound(6.0 * batch * S * D * D,
                       batch * T * D * 2 + 3 * D * D * 2 + 2 * D * 2 + 2 * D * 4
                       + 3 * batch * T * D * 2)
    print(f"K8 projection half encoder_ln_qkv [B={batch}, T_pad={T}, D={D}] -> q/k/v: per-entry "
          f"excess over one bf16 ulp {excess:.3e} of the largest entry (tol {K8_HALF_FLOOR}), "
          f"max_abs_err {abs_err:.3e} | kernel {ms:.4f} ms = {6.0 * batch * S * D * D / ms / 1e9:.0f} "
          f"TFLOP/s, plain {plain_ms:.3f} ms | library (F.layer_norm + 3 addmm) {library_ms:.4f} "
          f"ms, max_abs_err vs plain {lib_err:.3e} | bound {b_ms:.4f} ms ({b_by}), "
          f"{b_ms / ms:.1%} of it")
    if excess > K8_HALF_FLOOR:
        fail("K8's projection half disagrees with its plain version")
    return dict(max_abs_err=abs_err, ulp_excess=excess, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


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
    half = k8_projection_half(args, x, p, lns, lnb, batch, T, D, H, S)
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
                            "addmm + scaled_dot_product_attention", "projection_half": half}))
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
    C, rows_per = s8_split(Sm, True)
    smem, regs = decode_self.shared_bytes(Sm), ptxas_of("s8_decode_kernelILi1ELi1E")
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
        slab_bytes = 2 * batch * n * Dd + 2 * 4 * batch * Hd * n
        b_ms, b_by = bound(4.0 * batch * Hd * n * 64,
                           slab_bytes + batch * Dd + 4 * batch * Hd + 2 * batch * Dd,
                           PEAK_INT8_OPS)
        by_len[n] = dict(max_abs_err=abs_err, max_rel_err=rel_err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, gbps=slab_bytes / ms / 1e6)
        print(f"K9 self_decode_attention s8 [L={L}, B={batch}, max_len={Sm}, D={Dd}, n={n}, all "
              f"{L} layers]: max_abs_err {abs_err:.3e} max_rel_err {rel_err:.3e} (tol "
              f"{S8_ABS_TOL} abs or {S8_REL_TOL} rel) | per call over a {L}-layer sweep: kernel "
              f"{ms:.4f} ms plain {plain_ms:.4f} ms | {slab_bytes / 1e6:.2f} MB of the first n "
              f"rows -> {slab_bytes / ms / 1e6:.1f} GB/s | bound {b_ms:.5f} ms ({b_by}) | "
              f"clusters of C={C} blocks of {rows_per} rows per (head, sample) | shared memory "
              f"{smem} B per block | ptxas {regs} | library: none")
    rows.append(dict(name="self_decode_attention", route="cuda",
                     source="sar_tpu_torch/csrc/decode_s8.cu",
                     replaces="sar_tpu/ops/attic/decode_self.py:80", library_ms=None,
                     **{k: v for k, v in by_len[Sm].items() if k not in ("max_rel_err", "gbps")},
                     extra={"by_valid_len": by_len, "cluster": C, "slice_rows": rows_per,
                            "smem": smem, "ptxas": regs,
                            "standalone": "no caller in either package"}))
    del cache

    # K10: q [B, H, 64] against the cross shape's k/v [B, H, S, 64], full
    # and masked to K10_MASKED_LEN, each with SDPA of one query row; timed
    # cold over K10_SETS k/v sets (warm beside it).
    q = (torch.randn((batch, H, 64), generator=g, device=device) * 0.125).to(bf16)
    kv_sets = [tuple(torch.randn((batch, H, S, 64), generator=g, device=device).to(bf16)
                     for _ in range(2)) for _ in range(K10_SETS)]
    k, v = kv_sets[0]
    variants = {}
    for label, n in (("full", None), ("masked", K10_MASKED_LEN)):
        got = attention.decode_attention(q, k, v, n)
        again = attention.decode_attention(q, k, v, n)
        want = attention.decode_attention_reference(q, k, v, n)
        torch.cuda.synchronize()
        abs_err, rel_err = _attn_errors(got, want)
        if abs_err > ATTN_ABS_TOL or rel_err > ATTN_REL_TOL:
            fail(f"K10 ({label}) disagrees with its plain version")
        if not torch.equal(got, again):
            fail(f"K10 ({label}) gave two outputs on one input")
        mask = None if n is None else (torch.arange(S, device=device) < n)[None, None, None, :]
        sdpa = lambda k, v: F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                                           scale=1.0)
        lib_err = _attn_errors(sdpa(k, v)[:, :, 0], want)[0]
        fns = {"kernel": lambda k, v: attention.decode_attention(q, k, v, n),
               "plain": lambda k, v: attention.decode_attention_reference(q, k, v, n),
               "sdpa": sdpa}
        cold = {name: time_cuda(lambda fn=fn: [fn(*kv) for kv in kv_sets]) / K10_SETS
                for name, fn in fns.items()}
        warm = {name: time_cuda(lambda fn=fn: fn(k, v)) for name, fn in fns.items()
                if name != "plain"}
        rows_read = S if n is None else n
        b_ms, b_by = bound(4.0 * batch * H * rows_read * 64,
                           2 * batch * H * rows_read * 64 * 2 + 2 * batch * H * 64 * 2)
        variants[label] = dict(max_abs_err=abs_err, ms=cold["kernel"], plain_ms=cold["plain"],
                               bound_ms=b_ms, bound_by=b_by, library_ms=cold["sdpa"],
                               warm_ms=warm["kernel"], warm_library_ms=warm["sdpa"])
        print(f"K10 decode_attention {label} [B={batch}, H={H}, S={S}"
              f"{'' if n is None else f', valid_len={n}'}] bf16: max_abs_err {abs_err:.3e} "
              f"max_rel_err {rel_err:.3e} (tol {ATTN_ABS_TOL}), two runs equal | cold, per call "
              f"over {K10_SETS} k/v sets ({K10_SETS * 2 * k.numel() * 2 / 1e6:.0f} MB): kernel "
              f"{cold['kernel']:.4f} ms plain {cold['plain']:.4f} ms library (SDPA, one query "
              f"row) {cold['sdpa']:.4f} ms | warm (one set replayed): kernel {warm['kernel']:.4f} "
              f"ms SDPA {warm['sdpa']:.4f} ms | SDPA max_abs_err vs plain {lib_err:.3e} | bound "
              f"{b_ms:.5f} ms ({b_by}), {b_ms / cold['kernel']:.1%} of it cold")
    del kv_sets, k, v
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

    def counted(fn, key="greedy"):
        """(fn(), launch counts, `key` decode steps run, wall seconds), the
        counters zeroed before and read after."""
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, read_counts(), read_steps()[key], wall

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

    greedy(ev, audio[:1])                               # warm-ups (captures), not counted
    greedy(hm, audio[:1])
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
    lock_steps = decode_steps(tok_f, cfg, P)[0]
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
    eager = ASREvaluator(cfg, params, flash="fq", capture=False, **kw)
    check_captured_equals_eager("fq greedy", tok_f, eager.dec(eager.prep(f0)))
    del eager

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
                            max_new_tokens=max_new_tokens), "classic")
    if tok_b.shape != (batch, ev.total) or tok_b.min() < 0 or tok_b.max() >= cfg.vocab_size:
        fail(f"default beam: bad token tensor {tuple(tok_b.shape)}")
    print(f"beam_decode with its defaults (the module function, eager; unquantized classic "
          f"cache, {batch} samples x {K} beams): {1e3 * wall_b / n_beam:.3f} ms/token-step over {n_beam} steps (cache + "
          f"loop) | launches {json.dumps(c_beam)}")
    check_counts("default beam", c_beam, want_zero=KERNEL_NAMES)
    return {"fq": c_fq, "fq_lora": c_lora, "beam_default": c_beam}


def phase_graphs(cfg, params, device, batch, profile=False):
    """The decode loop's compiled form at whisper-small, batch `batch`, on
    the greedy cell's clips: for greedy at each of GRAPH_TOKENS new tokens
    and beam BEAM_WIDTH at the first, an eager evaluator (capture=False)
    and a captured one (the default). The captured one's first batch (one
    eager pass, then the capture and instantiation of every segment it
    reaches) is timed on its own line with its graphs, nodes, seconds and
    peak memory; then eager, captured, captured, eager on one batch (at the
    longest greedy, captured then eager, once each), each
    with its tokens (captured = eager), ms per step run, steps needed and
    run, host syncs and peak memory. One decode step captured alone is held
    to its eager logits. With `profile`, one captured and one eager 64-token
    greedy loop under torch.profiler (wall, device time, busy share, top
    kernels), and one captured at PROFILE_BIG_BATCH. Returns the launch
    counts of the captured runs."""
    import torch
    from sar_tpu_torch.decode import beam_decode
    from sar_tpu_torch.evaluation import ASREvaluator
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.ops import mel as mel_ops

    g = torch.Generator(device=device).manual_seed(SEED + 1)      # the greedy cell's clips
    audio = [torch.randn((batch, mel_ops.N_SAMPLES), generator=g, device=device) * 0.1
             for _ in range(2)]
    feats = [mel_ops.log_mel_spectrogram(a, cfg.num_mel_bins, dtype=torch.bfloat16)[
        :, :, :cfg.num_audio_frames] for a in audio]
    L, K = cfg.decoder_layers, BEAM_WIDTH
    total_counts = dict.fromkeys(COUNTED_NAMES, 0)
    t_phase = time.perf_counter()

    def decode(ev, f):
        """One batch: the prep, then the fenced loop -> (tokens, prep s,
        loop s, steps, host syncs, launches, peak GB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        cache = (ev.prep(f) if ev.num_beams == 1 else
                 ev.runner.prep(ev.encode(f), ev.total, self_batch=batch * ev.num_beams,
                                **ev._flags))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reset_counts()
        tokens = (ev.dec(cache) if ev.num_beams == 1 else
                  ev.runner.beam(cache, ev._prompt, num_beams=ev.num_beams))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        st, c = read_steps(), read_counts()
        return (tokens, t1 - t0, t2 - t1, sum(v for k, v in st.items() if k != "host_syncs"),
                st["host_syncs"], c, torch.cuda.max_memory_allocated(device) / 1e9)

    for new in (*GRAPH_TOKENS, None):
        beams = 1 if new is not None else K
        new = GRAPH_TOKENS[0] if new is None else new
        label = f"greedy {new}" if beams == 1 else f"beam {beams} {new}"
        kw = dict(language="hindi", max_new_tokens=new, num_beams=beams, device=device)
        eager = ASREvaluator(cfg, params, capture=False, **kw)
        cap = ASREvaluator(cfg, params, **kw)
        # The capture pass: the key's first batch (batch 1), on its own.
        first = decode(cap, feats[1])
        gs = cap.runner.graph_stats()
        print(f"graphs {label}: first batch of the key (eager pass + capture) prep "
              f"{first[1] * 1e3:.1f} ms, loop {first[2] * 1e3:.1f} ms for {first[3]} steps | "
              f"{gs['graphs']} graphs, {gs['nodes']} nodes ({gs['nodes'] / max(first[3], 1):.0f} "
              f"per step), capture + instantiate {gs['capture_s']:.3f} s | peak "
              f"{first[6]:.3f} GB")
        runs = {"eager": [], "captured": []}
        order = ((("eager", eager), ("captured", cap), ("captured", cap), ("eager", eager))
                 if new == GRAPH_TOKENS[0] else (("captured", cap), ("eager", eager)))
        for name, ev in order:
            runs[name].append(decode(ev, feats[0]))
        (tok_e, *_), (tok_c, *_) = runs["eager"][0], runs["captured"][0]
        check_captured_equals_eager(f"graphs {label}", tok_c, tok_e)
        if not all(torch.equal(r[0], tok_c) for r in runs["captured"] + runs["eager"]):
            fail(f"graphs {label}: a repeated run changed the tokens")
        if beams == 1:
            needed, want_run = decode_steps(tok_c, cfg, len(cfg.prompt_ids("hindi")))
        else:
            # Beams: the steps a per-step stop check would run.
            reset_counts()
            beam_decode(params, eager.encode(feats[0]), cfg, eager._prompt, num_beams=K,
                        max_new_tokens=new, segment=1, **INT8)
            needed, want_run = read_steps()["beam"], runs["eager"][0][3]
        c_e, c_c = runs["eager"][0][5], runs["captured"][0][5]
        kernel = ("cross_decode_attention_exact" if beams == 1 else
                  "cross_decode_attention_exact_beam")
        for name, rs in runs.items():
            steps, syncs = rs[0][3], rs[0][4]
            ms = statistics.mean(r[2] for r in rs) * 1e3
            prep = statistics.mean(r[1] for r in rs) * 1e3
            audio_s = batch * mel_ops.CHUNK_SECONDS
            print(f"graphs {label} {name}: loop {ms:.1f} ms = {ms / steps:.3f} ms per step run "
                  f"({steps} run, {needed} needed) | prep {prep:.1f} ms | RTFx (prep + loop) "
                  f"{audio_s * 1e3 / (prep + ms):.1f} | {syncs} host syncs per batch | peak "
                  f"{max(r[6] for r in rs):.3f} GB | walls "
                  f"{[round(r[2] * 1e3, 1) for r in rs]} ms")
            if steps != want_run or syncs != segments_run(eager.total, steps):
                fail(f"graphs {label} {name}: {steps} steps and {syncs} syncs, the tokens "
                     f"predict {want_run} steps")
        if c_e != c_c or c_c[kernel] != L * runs["captured"][0][3]:
            fail(f"graphs {label}: captured launches {c_c}, eager {c_e}")
        for k in COUNTED_NAMES:
            total_counts[k] += sum(r[5][k] for r in runs["captured"])
        if profile and beams == 1 and new == GRAPH_TOKENS[0]:
            for name, ev in (("captured", cap), ("eager", eager)):
                profile_loop(f"graphs greedy {new} {name} loop, batch {batch}", ev, feats[0],
                             runs[name][0][3])
        del eager, cap

    if profile:
        # The captured loop where the device, not the host, sets the pace.
        big = [torch.randn((PROFILE_BIG_BATCH, mel_ops.N_SAMPLES), generator=g,
                           device=device) * 0.1]
        f_big = mel_ops.log_mel_spectrogram(big[0], cfg.num_mel_bins, dtype=torch.bfloat16)[
            :, :, :cfg.num_audio_frames]
        ev = ASREvaluator(cfg, params, language="hindi", max_new_tokens=GRAPH_TOKENS[0],
                          device=device)
        ev.dec(ev.prep(f_big))                                    # the capture pass
        reset_counts()
        ev.dec(ev.prep(f_big))
        profile_loop(f"graphs greedy {GRAPH_TOKENS[0]} captured loop, batch "
                     f"{PROFILE_BIG_BATCH}", ev, f_big, read_steps()["greedy"])
        del ev, big, f_big

    # One decode step captured alone against its eager logits.
    ev = ASREvaluator(cfg, params, language="hindi", max_new_tokens=GRAPH_TOKENS[0],
                      device=device, capture=False)
    cache = ev.prep(feats[0])
    ref = whisper.DecodeCache(*(x.clone() for x in cache))
    tok = ev._prompt[:1].expand(batch).contiguous()
    with torch.no_grad():
        want, _ = whisper.decode_step(params, tok, 0, ref, cfg, self_len=32)
        step = lambda: whisper.decode_step(params, tok, 0, cache, cfg, self_len=32)[0]
        step()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = step()
        graph.replay()
    torch.cuda.synchronize()
    dlogit = (out - want).abs().max().item()
    print(f"graphs: one captured decode step against its eager logits: max |dlogit| "
          f"{dlogit:.4e} ({'bit for bit' if dlogit == 0 else 'cuBLAS took another algorithm'})"
          f" | argmax equal {bool(torch.equal(out.argmax(-1), want.argmax(-1)))}")
    if not torch.equal(out.argmax(-1), want.argmax(-1)):
        fail("graphs: the captured step's argmax differs from the eager step's")
    print(f"graphs: {time.perf_counter() - t_phase:.1f} s | launches {json.dumps(total_counts)}")
    return total_counts


DECODE_KERNELS = ("cross_decode_attention_exact", "cross_decode_attention_exact_beam",
                  *K7_NAMES)


def phase_bench(cfg, device):
    """The benchmark CLI's rows through `benchmark.main`, one call per row,
    with the launch counters and the decode steps (by cache layout) counted
    around each; returns the counts summed over the rows."""
    import torch
    from sar_tpu_torch.scripts import benchmark

    common = ["--model", cfg.name, "--device", str(device), "--batch_sizes", str(BATCH),
              "--max_new_tokens", str(MAX_NEW_TOKENS), "--iters", str(BENCH_ITERS)]
    rows = [("int8", ["--kv_cache", "int8"]),
            ("int8 classic", ["--kv_cache", "int8", "--kv_layout", "classic"]),
            ("bf16", ["--kv_cache", "bf16"]),
            ("int4", ["--kv_cache", "int4"]),
            ("beam 4", ["--num_beams", str(BEAM_WIDTH)]),
            ("s8", ["--attn_scores", "int8"]),
            ("train", ["--train", "--train_accum", "2"]),
            ("routed", ["--routed", "--routed_lid_layer", str(LID_LAYER)]),
            ("serving", ["--serving", "--serving_requests", str(BENCH_SERVING_REQUESTS)])]
    total = dict.fromkeys(COUNTED_NAMES, 0)
    t_phase = time.perf_counter()
    for name, extra in rows:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        report = benchmark.main(common + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = read_counts()
        # Decode steps run by cache layout (head-minor greedy, beam, s8;
        # classic), captured replays included.
        steps = {k: v for k, v in read_steps().items() if v and k != "host_syncs"}
        for k in total:
            total[k] += c[k]
        res = report["results"]
        if len(res) != 1 or "error" in res[0]:
            fail(f"bench {name}: want one row without an error, got {res}")
        row = res[0]
        agree = {k: v for k, v in row.items() if k.startswith("token_agreement")}
        if any(not 0.0 <= v <= 1.0 for v in agree.values()):
            fail(f"bench {name}: agreement out of [0, 1]: {agree}")
        hm, beam, s8 = (steps.get(k, 0) for k in ("greedy", "beam", "s8"))
        dec = {k: c[k] for k in DECODE_KERNELS}
        print(f"bench {name}: {wall:.1f} s | {json.dumps(row)} | peak "
              f"{report.get('peak_mem_gb')} GB | steps {json.dumps(steps)} | "
              f"launches {json.dumps({k: v for k, v in c.items() if v})}")
        want_dec = None
        if name == "int8":
            if row["layout"] != "head_minor" or "token_agreement_vs_classic" not in agree:
                fail(f"bench int8: layout {row['layout']}, agreement keys {list(agree)}")
            if hm == 0 or c["fused_kv_init"] == 0:
                fail(f"bench int8: {hm} head-minor steps, K2 {c['fused_kv_init']}")
            want_dec = dict.fromkeys(DECODE_KERNELS, 0) | {
                "cross_decode_attention_exact": 12 * hm}
        elif name in ("int8 classic", "bf16", "int4"):
            if row["layout"] != "classic" or hm + beam + s8 != 0:
                fail(f"bench {name}: layout {row['layout']}, head-minor steps "
                     f"{hm + beam + s8}")
            want_dec = dict.fromkeys(DECODE_KERNELS, 0)
            if name == "int4" and "token_agreement_vs_int8" not in agree:
                fail("bench int4: no token_agreement_vs_int8")
        elif name == "beam 4":
            if beam == 0:
                fail("bench beam 4: no head-minor beam step")
            want_dec = dict.fromkeys(DECODE_KERNELS, 0) | {
                "cross_decode_attention_exact_beam": 12 * beam}
        elif name == "s8":
            if "token_agreement_vs_bf16" not in agree or s8 == 0:
                fail(f"bench s8: agreement keys {list(agree)}, {s8} s8 steps")
            want_dec = dict.fromkeys(DECODE_KERNELS, 0) | {
                "cross_decode_attention": 12 * s8}
        elif name == "train":
            if min(c[k] for k in K6_NAMES) == 0:
                fail(f"bench train: K6 launched {[c[k] for k in K6_NAMES]}")
        elif name == "routed":
            if c["fused_kv_init_lora"] == 0 or c["cross_decode_attention_exact"] != 12 * hm:
                fail(f"bench routed: K4 {c['fused_kv_init_lora']}, K3 "
                     f"{c['cross_decode_attention_exact']} for {hm} steps")
            if row["token_agreement_vs_oracle"] < LOCKSTEP_MIN_AGREEMENT:
                fail(f"bench routed: routed vs oracle tokens "
                     f"{row['token_agreement_vs_oracle']}")
        elif name == "serving":
            if row["requests"] != BENCH_SERVING_REQUESTS or row["batches"] < 2:
                fail(f"bench serving: {row['requests']} requests in {row['batches']} batches")
        if want_dec is not None and dec != want_dec:
            fail(f"bench {name}: decode-kernel launches {dec}, the design says {want_dec}")
    print(f"bench: {len(rows)} rows in {time.perf_counter() - t_phase:.1f} s | launches "
          f"{json.dumps(total)}")
    check_counts("bench", total, want_zero=("cross_decode_attention_beam", *OFF_PATH))
    return total


def phase_lid(cfg, params, device, head_dir):
    """LID training on the cached-feature path at whisper-small (the
    trained head saved to `head_dir`, the classifier directory the route
    phase reads), then the router's teacher-forced strategies; returns the
    launch counts."""
    import numpy as np
    import torch
    from sar_tpu_torch.data import DataLoader, LIDCollator, SyntheticASRDataset
    from sar_tpu_torch.models import classifier as clf
    from sar_tpu_torch.models import lora as lora_lib
    from sar_tpu_torch.models.config import TARGET_LANGUAGES
    from sar_tpu_torch.models.router import AdapterRouter
    from sar_tpu_torch.training.lid_trainer import LIDDataset, LIDTrainer, LIDTrainingArgs

    t_phase = time.perf_counter()
    langs = tuple(TARGET_LANGUAGES)
    ds = {l: SyntheticASRDataset(cfg, size=LID_ITEMS, language=l, language_id=i, seed=i)
          for i, l in enumerate(langs)}
    g = torch.Generator(device=device).manual_seed(SEED + 6)
    ccfg = clf.ClassifierConfig(input_dim=clf.get_hidden_dim(cfg), hidden_dims=(256, 128),
                                num_classes=len(langs), dropout=0.1, pooling="mean",
                                languages=langs, encoder_layer=LID_LAYER)
    trainer = LIDTrainer(cfg, params, clf.init_classifier(g, ccfg), ccfg, LIDTrainingArgs(
        learning_rate=1e-3, warmup_steps=5, max_steps=LID_STEPS, eval_steps=0,
        encoder_layer=LID_LAYER, seed=SEED, device=str(device)))
    loader = DataLoader(LIDDataset(ds, langs), BATCH,
                        LIDCollator(num_mels=cfg.num_mel_bins, num_frames=cfg.num_audio_frames),
                        shuffle=False, drop_last=False)
    trainer.features(next(loader.one_epoch())["input_features"])    # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    feats, labels = trainer.precompute_features(loader)
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    c_feat = read_counts()
    n_batches = len(loader)
    Le = LID_LAYER + 1
    print(f"lid features: {feats.shape[0]} items at layer {LID_LAYER} in {n_batches} batches "
          f"of {BATCH}: {1e3 * t_feat / n_batches:.2f} ms per batch | cache "
          f"{tuple(feats.shape)} {feats.dtype} | launches "
          f"{json.dumps({k: v for k, v in c_feat.items() if v})}")
    if c_feat["encoder_attention_hm"] != Le * n_batches:
        fail(f"lid features: K1 launched {c_feat['encoder_attention_hm']} times, the design "
             f"says {Le} per batch x {n_batches}")
    check_counts("lid features", c_feat, want_zero=tuple(
        k for k in KERNEL_NAMES if k != "encoder_attention_hm"))
    if not bool(torch.isfinite(feats.float()).all()):
        fail("lid features: non-finite features")
    t0 = time.perf_counter()
    hist = trainer.train_cached(feats, labels, batch_size=LID_BATCH)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    ev = trainer.evaluate_cached(feats, labels)
    losses = hist["loss"]
    if len(losses) != LID_STEPS or not np.isfinite(losses).all():
        fail(f"lid train: {len(losses)} steps, losses {losses[:3]} ...")
    print(f"lid train (cached, batch {LID_BATCH}): {LID_STEPS} steps, "
          f"{1e3 * t_train / LID_STEPS:.3f} ms per step | loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} | eval accuracy {ev['accuracy']:.4f} over {ev['num_samples']} "
          f"(random encoder weights: the path, not the accuracy)")
    trainer.save_checkpoint(head_dir)

    lcfg = lora_lib.LoraConfig(r=LORA_RANK, alpha=LORA_ALPHA, dropout=0.0,
                               target_modules=("q_proj", "v_proj"))
    bank = lora_lib.map_with_path(
        lambda path, x: (torch.randn(x.shape, generator=g, device=device) * LORA_B_STD
                         if path[-1] == "b" else x),
        lora_lib.init_lora(g, cfg, lcfg, num_adapters=len(langs)))
    head = {k: {kk: v.detach() for kk, v in d.items()} for k, d in trainer.params.items()}
    mel = torch.as_tensor(next(loader.one_epoch())["input_features"]).to(device)
    lab = torch.randint(0, cfg.vocab_size, (mel.shape[0], LID_LABEL_LEN), generator=g,
                        device=device)
    total = dict(c_feat)
    for strategy, threshold in (("hard", 0.7), ("soft", 0.7), ("threshold", 0.7)):
        router = AdapterRouter(cfg, params, bank, lcfg, head, trainer.clf_cfg,
                               strategy=strategy, threshold=threshold, device=device)
        router.forward(mel, lab)                                     # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = router.forward(mel, lab)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = read_counts()
        for k in total:
            total[k] += c[k]
        passes = (len(langs) if strategy == "soft" or (strategy == "threshold"
                                                       and not bool(out["confident"]))
                  else 1)
        fwd = cfg.encoder_layers + 2 * cfg.decoder_layers     # K6 forwards per pass
        print(f"lid router.forward({strategy}): {1e3 * dt:.1f} ms | loss "
              f"{float(out['loss']):.4f} | logits {tuple(out['logits'].shape)} | "
              f"{passes} teacher-forced pass(es) | launches "
              f"{json.dumps({k: v for k, v in c.items() if v})}")
        if not bool(torch.isfinite(out["logits"]).all()) or not np.isfinite(float(out["loss"])):
            fail(f"lid router.forward({strategy}): non-finite output")
        if (c["flash_attention_fwd"], c["encoder_attention_hm"]) != (fwd * passes, Le):
            fail(f"lid router.forward({strategy}): K6 forward {c['flash_attention_fwd']}, K1 "
                 f"{c['encoder_attention_hm']}; the design says {fwd * passes} and {Le}")
        check_counts(f"lid router.forward({strategy})", c, want_zero=tuple(
            k for k in KERNEL_NAMES if k not in ("encoder_attention_hm", "flash_attention_fwd")))
    print(f"lid: {time.perf_counter() - t_phase:.1f} s | launches {json.dumps(total)}")
    return total


def phase_sweep(cfg, device, work):
    """The LID sweep CLI (sar_tpu_torch.scripts.lid_sweep) in-process at
    whisper-small with its own random bf16 weights, SWEEP_LAYERS x
    SWEEP_POOLINGS; returns the launch counts."""
    import numpy as np
    import torch
    from sar_tpu_torch.models.config import TARGET_LANGUAGES
    from sar_tpu_torch.scripts import lid_sweep

    langs = list(TARGET_LANGUAGES)
    out = Path(work) / "lid_sweep.json"
    argv = ["--model", cfg.name, "--device", str(device), "--languages", *langs,
            "--layers", *map(str, SWEEP_LAYERS), "--poolings", *SWEEP_POOLINGS,
            "--samples_per_language", str(SWEEP_TRAIN),
            "--eval_samples_per_language", str(SWEEP_EVAL),
            "--batch_size", str(SWEEP_BATCH), "--max_steps", str(SWEEP_STEPS),
            "--iters", str(SWEEP_ITERS), "--output", str(out)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    report = lid_sweep.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = read_counts()
    if json.loads(out.read_text()) != json.loads(json.dumps(report)):
        fail("sweep: the written report differs from the returned one")
    cells = {(r["encoder_layer"], r["pooling"]): r for r in report["results"]}
    want_cells = {(l, p) for l in SWEEP_LAYERS for p in SWEEP_POOLINGS}
    if set(cells) != want_cells or len(report["results"]) != len(want_cells):
        fail(f"sweep: cells {sorted(cells)}, want {sorted(want_cells)}")
    n_eval = SWEEP_EVAL * len(langs)
    for (layer, pooling), r in sorted(cells.items()):
        accs = [r["accuracy"], *r["per_class_accuracy"].values()]
        if not all(0.0 <= a <= 1.0 for a in accs) or len(accs) != len(langs) + 1:
            fail(f"sweep {layer}/{pooling}: accuracies {accs}")
        if sum(map(sum, r["confusion_matrix"])) != n_eval:
            fail(f"sweep {layer}/{pooling}: the confusion matrix sums to "
                 f"{sum(map(sum, r['confusion_matrix']))}, not {n_eval}")
        if not r["lid_ms_per_utt"] > 0 or not np.isfinite(r["eval_loss"]):
            fail(f"sweep {layer}/{pooling}: lid_ms_per_utt {r['lid_ms_per_utt']}, "
                 f"eval_loss {r['eval_loss']}")
        print(f"sweep {layer}/{pooling}: accuracy {r['accuracy']:.4f} | eval loss "
              f"{r['eval_loss']:.4f} | train {r['train_s']} s for {SWEEP_STEPS} cached steps "
              f"of {SWEEP_BATCH} | confusion {r['confusion_matrix']}")
    for layer in SWEEP_LAYERS:
        print(f"sweep tap layer {layer}: {cells[layer, SWEEP_POOLINGS[0]]['lid_ms_per_utt']} "
              f"ms per utterance (batch {SWEEP_BATCH}; the layers run: "
              f"{cfg.encoder_layers if layer < 0 else layer + 1})")
    # K1 in every layer run by the timing taps (a warm-up and the timed
    # iterations) and by the train and eval feature passes of each layer.
    n_train = -(-SWEEP_TRAIN * len(langs) // SWEEP_BATCH)
    n_eval_b = -(-n_eval // SWEEP_BATCH)
    calls = 1 + SWEEP_ITERS + n_train + n_eval_b
    want_k1 = sum(calls * (cfg.encoder_layers if l < 0 else l + 1) for l in SWEEP_LAYERS)
    print(f"sweep: {wall:.1f} s | chosen {json.dumps(report['chosen_default'])} | backend "
          f"{report['backend']} | launches {json.dumps({k: v for k, v in c.items() if v})}")
    if c["encoder_attention_hm"] != want_k1:
        fail(f"sweep: K1 launched {c['encoder_attention_hm']} times, the design says "
             f"{want_k1} ({calls} encoder calls per layer)")
    check_counts("sweep", c, want_zero=tuple(k for k in KERNEL_NAMES
                                             if k != "encoder_attention_hm"))
    return c


def _route_batch(cfg, device):
    """The first batch route_infer reads: item 0 then item 1 of each
    language's synthetic test split, interleaved -> (mel, true ids)."""
    import torch
    from sar_tpu_torch.data import create_collator, create_dataset
    from sar_tpu_torch.models.config import TARGET_LANGUAGES
    from sar_tpu_torch.scripts.route_infer import Interleaved

    per_lang = [create_dataset(l, ["synthetic"], "test", language_id=i,
                               max_samples=ROUTE_SAMPLES, model_config=cfg)
                for i, l in enumerate(TARGET_LANGUAGES)]
    ds = Interleaved(per_lang)
    batch = create_collator(cfg.sot_token_id, with_language=True,
                            num_mels=cfg.num_mel_bins, num_frames=cfg.num_audio_frames,
                            device=device)([ds[i] for i in range(BATCH)])
    return (torch.as_tensor(batch["input_features"]).to(device),
            torch.as_tensor(batch["language_ids"], dtype=torch.int64, device=device))


def phase_route(cfg, params, device, work):
    """Routed inference (route_infer's `route`) at whisper-small with phase
    4's weights, four saved adapters and the lid phase's head, then the
    router's checks on one batch and the adapter analysis of the four
    adapters; returns the launch counts of the route_infer run."""
    import torch
    from sar_tpu_torch.data import CharTokenizer
    from sar_tpu_torch.models import lora as lora_lib
    from sar_tpu_torch.models.config import TARGET_LANGUAGES
    from sar_tpu_torch.models.router import AdapterRouter
    from sar_tpu_torch.scripts import analyze_adapters, route_infer

    work = Path(work)
    langs = list(TARGET_LANGUAGES)
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    lcfg = lora_lib.LoraConfig(r=LORA_RANK, alpha=LORA_ALPHA, dropout=0.0,
                               target_modules=("q_proj", "v_proj"))
    for lang in langs:
        bank = lora_lib.map_with_path(
            lambda path, x: (torch.randn(x.shape, generator=g, device=device) * LORA_B_STD
                             if path[-1] == "b" else x),
            lora_lib.init_lora(g, cfg, lcfg, num_adapters=1))
        lora_lib.save_adapter(work / "adapters" / lang, bank, lcfg,
                              metadata={"language": lang})
    adapters = [f"{l}={work / 'adapters' / l}" for l in langs]
    args = route_infer.parse_args([
        "--model", cfg.name, "--device", str(device), "--classifier", str(work / "lid"),
        "--adapters", *adapters, "--data_sources", "synthetic",
        "--max_samples", str(ROUTE_SAMPLES), "--batch_size", str(BATCH),
        "--max_new_tokens", str(MAX_NEW_TOKENS), "--oracle",
        "--router_dir", str(work / "router"), "--output_dir", str(work / "route_out")])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:    # its results JSON
        results, router = route_infer.route(args, cfg, params, CharTokenizer(cfg), device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if json.loads(printed.getvalue()) != json.loads(json.dumps(results)):
        fail("route: the printed results differ from the returned ones")
    c = read_counts()
    steps = {k: v for k, v in read_steps().items() if v}
    n_items = ROUTE_SAMPLES * len(langs)
    n_batches = -(-n_items // BATCH)
    if set(results) != {"strategy", "lid_accuracy", "routing_overhead_ms", "per_language",
                        "overall"} or set(results["per_language"]) != set(langs):
        fail(f"route: result keys {sorted(results)}, languages {sorted(results['per_language'])}")
    if any(e["num_samples"] != ROUTE_SAMPLES or "oracle_wer" not in e
           for e in results["per_language"].values()):
        fail(f"route: per-language entries {results['per_language']}")
    if not 0.0 <= results["lid_accuracy"] <= 1.0:
        fail(f"route: lid_accuracy {results['lid_accuracy']}")
    saved = json.loads((work / "route_out" / "routing_results.json").read_text())
    if saved != json.loads(json.dumps(results)):
        fail("route: routing_results.json differs from the returned results")
    lid_passes = n_batches + route_infer.OVERHEAD_REPS
    want_k1 = lid_passes * (LID_LAYER + 1) + 2 * n_batches * cfg.encoder_layers
    print(f"route: {n_items} utterances in {n_batches} batches of {BATCH}, "
          f"{MAX_NEW_TOKENS} new tokens, --oracle: {wall:.1f} s ({wall / n_batches:.2f} s per "
          f"batch, the first batch's capture included) | lid_accuracy "
          f"{results['lid_accuracy']:.4f} | routing overhead "
          f"{results['routing_overhead_ms']:.3f} ms per utterance (the reference's target "
          f"< {ROUTING_TARGET_MS:g} ms) | overall {json.dumps(results['overall'])} | steps "
          f"{json.dumps(steps)} | launches {json.dumps({k: v for k, v in c.items() if v})}")
    if c["encoder_attention_hm"] != want_k1:
        fail(f"route: K1 launched {c['encoder_attention_hm']} times, the design says "
             f"{want_k1} ({lid_passes} LID passes x {LID_LAYER + 1} layers + "
             f"{2 * n_batches} generates x {cfg.encoder_layers})")
    # generate decodes over the unquantized classic cache, as JAX's: no
    # cache-build or decode kernel.
    check_counts("route", c, want_zero=tuple(k for k in KERNEL_NAMES
                                             if k != "encoder_attention_hm"))

    # One batch: routed and oracle walls (the captured program replayed),
    # the reloaded router (its first batch captures) and an eager router.
    mel, true_ids = _route_batch(cfg, device)

    def fenced(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    (idx, _), lid_ms = fenced(lambda: router.route(mel))
    tokens, routed_ms = fenced(lambda: router.generate(mel, adapter_idx=idx,
                                                       max_new_tokens=MAX_NEW_TOKENS))
    _, oracle_ms = fenced(lambda: router.generate(mel, adapter_idx=true_ids,
                                                  max_new_tokens=MAX_NEW_TOKENS))
    reloaded = AdapterRouter.load(work / "router", cfg, params, device=device)
    first, first_ms = fenced(lambda: reloaded.generate(mel, adapter_idx=idx,
                                                       max_new_tokens=MAX_NEW_TOKENS))
    again = reloaded.generate(mel, adapter_idx=idx, max_new_tokens=MAX_NEW_TOKENS)
    stats = reloaded.runner.graph_stats()
    eager = AdapterRouter.load(work / "router", cfg, params, device=device, capture=False)
    eager_tokens, eager_ms = fenced(lambda: eager.generate(mel, adapter_idx=idx,
                                                           max_new_tokens=MAX_NEW_TOKENS))
    print(f"route batch of {BATCH}: LID {lid_ms:.1f} ms | routed generate {routed_ms:.1f} ms | "
          f"oracle generate {oracle_ms:.1f} ms | eager routed generate {eager_ms:.1f} ms | "
          f"the reloaded router's first batch {first_ms:.1f} ms (capture "
          f"{stats.get('capture_s', 0.0):.2f} s, {json.dumps(stats)}) | routed vs oracle "
          f"adapters equal on {int((idx == true_ids).sum())} of {BATCH} rows")
    for label, other in (("the reloaded router's first batch", first),
                         ("the reloaded router's replay", again)):
        if not bool((other == tokens).all()):
            fail(f"route: {label} gives other tokens than the route_infer router's")
    print(f"route: the reloaded router's tokens equal the route_infer router's "
          f"(first batch and replay)")
    check_captured_equals_eager("route", tokens, eager_tokens)
    del reloaded, eager

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:    # its tables
        report = analyze_adapters.main(["--adapters", *adapters, "--top_k", "3",
                                        "--output", str(work / "analysis.json")])
    if json.loads((work / "analysis.json").read_text()) != json.loads(json.dumps(report)):
        fail("route analysis: the written report differs from the returned one")
    targets = {f"{side}.{hook}" for side, hooks in lora_lib.init_lora(
        g, cfg, lcfg, num_adapters=1).items() for hook in hooks}
    for lang in langs:
        layers = report["adapters"][lang]["layers"]
        n_rows = {t: len(rows) for t, rows in layers.items()}
        want_rows = {t: cfg.encoder_layers if t.startswith("encoder") else cfg.decoder_layers
                     for t in targets}
        if n_rows != want_rows:
            fail(f"route analysis {lang}: rows per target {n_rows}, want {want_rows}")
    if len(report["pairwise_similarity"]) != len(langs) * (len(langs) - 1) // 2:
        fail(f"route analysis: pairwise similarities {report['pairwise_similarity']}")
    print(f"route analysis: {len(langs)} adapters x {len(targets)} targets in "
          f"{time.perf_counter() - t0:.1f} s ({len(printed.getvalue().splitlines())} lines "
          f"printed) | pairwise mean cosine "
          f"{json.dumps(report['pairwise_similarity'])}")
    return c


def write_wav(path, seconds: float, sr: int, seed: int) -> None:
    """`seconds` of seeded 16-bit noise at `sr` Hz, mono."""
    import wave

    import numpy as np
    samples = np.random.default_rng(seed).standard_normal(int(seconds * sr)) * 3000
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(samples.astype(np.int16).tobytes())


@contextlib.contextmanager
def recording_transcribers():
    """Every FallbackTranscriber made inside the block, in order, each
    with the info rows of its calls (`infos`), so that the caller can read
    its runner's graphs and the temperatures its windows reached."""
    from sar_tpu_torch.evaluation import fallback
    made, cls = [], fallback.FallbackTranscriber

    class Recording(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.infos = []
            made.append(self)

        def __call__(self, *a, **k):
            out = super().__call__(*a, **k)
            self.infos.append([r for r in out[1] if r is not None])
            return out

    fallback.FallbackTranscriber = Recording
    try:
        yield made
    finally:
        fallback.FallbackTranscriber = cls


def fallback_passes(rows, temperatures, best_of: int) -> int:
    """The decode passes of one FallbackTranscriber call whose accepted
    rows are `rows`: one per temperature up to the highest one a row
    reached, `best_of` at T > 0."""
    reached = max(temperatures.index(r["temperature"]) for r in rows)
    return sum(1 if t == 0.0 else best_of for t in temperatures[:reached + 1])


def check_output_formats(out_dir, stem: str, text: str, segments, words) -> dict:
    """Write every --output_format file of one transcript with the port's
    writers and parse each back: txt is the text, json holds the text,
    segments and words, srt/vtt/tsv hold one cue per segment with
    well-formed times. Returns {format: bytes written}."""
    import re

    from sar_tpu_torch.evaluation import writers
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sizes = {}
    for fmt in writers.WRITERS:
        path = out_dir / f"{stem}.{fmt}"
        path.write_text(writers.render(fmt, text, segments=segments, words=words))
        body = path.read_bytes().decode()
        sizes[fmt] = len(body.encode())
        n = len(segments)
        if fmt == "txt":
            ok = body == text.strip() + "\n"
        elif fmt == "json":
            obj = json.loads(body)
            ok = (obj["text"] == text.strip() and len(obj["segments"]) == n
                  and len(obj["words"]) == len(words))
        elif fmt == "srt":
            ok = len(re.findall(r"^\d+\n\d\d:\d\d:\d\d,\d{3} --> \d\d:\d\d:\d\d,\d{3}$",
                                body, re.M)) == n
        elif fmt == "vtt":
            ok = body.startswith("WEBVTT") and len(re.findall(
                r"^(\d\d:)?\d\d:\d\d\.\d{3} --> (\d\d:)?\d\d:\d\d\.\d{3}$", body, re.M)) == n
        else:
            # (a cue's text may hold line breaks: count the cue starts)
            ok = body.startswith("start\tend\ttext\n") and len(re.findall(
                r"^\d+\t\d+\t", body, re.M)) >= n
        if not ok:
            fail(f"transcribe: the {fmt} output does not parse:\n{body[:500]}")
    return sizes


def phase_transcribe(cfg, params, device, work):
    """Single-file transcription at whisper-small with phase 4's weights, in
    process: a 75 s WAV at 44.1 kHz through load_audio (the native
    resampler) into three 30 s windows, then (a) plain long-form
    (batch_transcribe: exact encoder, unquantized classic cache, no
    kernel); (b) the CLI's --fallback --timestamps --word_timestamps
    --best_of 2 over the full ladder (K1 per group, K2 per pass, K3 12 per
    step, one captured program), its output in every format, and its
    captured passes against an eager runner's at T = 0 and T > 0 with one
    seed; (c) --condition_on_previous_text, one window after another (one
    program, replayed across windows); (d) one 25 s window with
    --num_beams 4 --timestamps --language auto (no kernel); (e) (b)'s group
    again with a q/v adapter (K4 per pass, no K2); (f) two files through
    the CLI's default path, replaying (a)'s kept program (no capture).
    Prints RTFx per mode, capture seconds, passes per window and the
    escalation rate; returns the summed launch counts of (a)-(e)."""
    import torch
    from sar_tpu_torch.data import CharTokenizer
    from sar_tpu_torch.data.preprocessing import load_audio
    from sar_tpu_torch.decode.graphs import DecodeRunner
    from sar_tpu_torch.decode.segments import grid
    from sar_tpu_torch.evaluation import fallback, longform
    from sar_tpu_torch.models import lora as lora_lib
    from sar_tpu_torch.scripts import transcribe
    from sar_tpu_torch.utils import native

    work = Path(work)
    tok = CharTokenizer(cfg)
    L = cfg.decoder_layers
    long_wav, short_wav = work / "long.wav", work / "short.wav"
    write_wav(long_wav, TRANSCRIBE_SECONDS, TRANSCRIBE_SR, SEED + 11)
    write_wav(short_wav, SINGLE_WINDOW_SECONDS, 16000, SEED + 12)
    if not native.native_available():
        fail("transcribe: the native host components (g++) did not build: the 44.1 kHz "
             "resample needs the polyphase kernel")
    t0 = time.perf_counter()
    audio = load_audio(long_wav)
    t_load = time.perf_counter() - t0
    windows = len(longform.chunk_audio(audio))
    print(f"transcribe setup: {TRANSCRIBE_SECONDS} s at {TRANSCRIBE_SR} Hz -> "
          f"{len(audio)} samples at 16 kHz in {t_load:.2f} s (resample path "
          f"{native.ACTIVE_PATH}) -> {windows} windows of 30 s")
    if windows != 3 or len(audio) != TRANSCRIBE_SECONDS * 16000:
        fail(f"transcribe: {len(audio)} samples, {windows} windows")
    total = dict.fromkeys(COUNTED_NAMES, 0)
    temps = fallback.DEFAULT_TEMPERATURES

    def counted(fn):
        """fn() with the counters zeroed before and read after, fenced."""
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        c, steps = read_counts(), read_steps()
        for k in total:
            total[k] += c[k]
        return out, wall, c, steps

    def cli(wav, *flags):
        return transcribe.parse_args([str(wav), "--model", cfg.name, "--language", "hindi",
                                      "--max_new_tokens", str(MAX_NEW_TOKENS),
                                      "--device", str(device), *flags])

    # (a) plain long-form.
    text_a, wall_a, c, _ = counted(lambda: longform.transcribe_long(
        audio, cfg, params, tok, language="hindi", max_new_tokens=MAX_NEW_TOKENS,
        device=device))
    check_counts("transcribe (a) plain long-form", c, want_zero=KERNEL_NAMES)
    print(f"transcribe (a) plain long-form (batch_transcribe, unquantized cache): "
          f"{wall_a:.2f} s, the first batch's capture included -> RTFx "
          f"{TRANSCRIBE_SECONDS / wall_a:.1f} | {len(text_a)} characters | no kernel")

    # (b) fallback + timestamps + words, best_of 2, the full ladder.
    out_b = work / "out_b"
    args_b = cli(long_wav, "--fallback", "--timestamps", "--word_timestamps", "--best_of",
                 str(TRANSCRIBE_BEST_OF), "--output_format", "json", "--output_dir",
                 str(out_b))
    with recording_transcribers() as made:
        _, wall_b, c, steps_b = counted(lambda: transcribe.run(
            args_b, cfg, params, tok, device=device))
    tr = made[0]
    if len(made) != 1 or len(tr.infos) != 1:
        fail(f"transcribe (b): {len(made)} transcribers, {[len(i) for i in tr.infos]} calls")
    rows = tr.infos[0]
    passes = fallback_passes(rows, temps, TRANSCRIBE_BEST_OF)
    escalated = sum(r["temperature"] > 0 for r in rows)
    stats_b = tr.runner.graph_stats()
    print(f"transcribe (b) --fallback --timestamps --word_timestamps --best_of "
          f"{TRANSCRIBE_BEST_OF}: {wall_b:.2f} s -> RTFx {TRANSCRIBE_SECONDS / wall_b:.1f} | "
          f"{passes} passes per window ({len(rows)} windows in one group), escalation rate "
          f"{escalated / len(rows):.2f}, accepted at T = "
          f"{[r['temperature'] for r in rows]} | graphs {json.dumps(stats_b)} | steps "
          f"{json.dumps({k: v for k, v in steps_b.items() if v})} | launches "
          f"{json.dumps({k: v for k, v in c.items() if v})}")
    want = {"encoder_attention_hm": cfg.encoder_layers, "fused_kv_init": passes,
            "cross_decode_attention_exact": L * steps_b["greedy"]}
    if {k: c[k] for k in want} != want or steps_b["greedy"] == 0:
        fail(f"transcribe (b): launches {c}, the design says {want}")
    check_counts("transcribe (b)", c, want_zero=tuple(k for k in KERNEL_NAMES if k not in want))
    if stats_b["programs"] != 1:
        fail(f"transcribe (b): {stats_b['programs']} programs for one key")
    written = json.loads((out_b / "long.json").read_text())
    segs = [tuple(sg.values()) for sg in written["segments"]]
    sizes = check_output_formats(out_b, "long", written["text"], segs, written["words"])
    print(f"transcribe (b) outputs: {len(segs)} segments, {len(written['words'])} words; "
          f"every format written and parsed ({json.dumps(sizes)} bytes)")

    # (b)'s passes captured against an eager runner, at T = 0 and T > 0.
    feats = longform.window_features(longform.chunk_audio(audio), cfg, device, BATCH)
    enc = tr.encode(feats)
    eager = DecodeRunner(tr.params, cfg)
    opts = dict(with_logprobs=True, with_no_speech=True, timestamps=True,
                max_gen_tokens=MAX_NEW_TOKENS)
    def timed_pass(runner, temp, seed):
        """One fallback pass (prep + loop), fenced: (outputs, ms per step run)."""
        torch.cuda.synchronize()
        steps0, t = read_steps()["greedy"], time.perf_counter()
        out = runner.greedy(runner.prep(enc, tr.total, **tr._flags), tr._prompt,
                            temperature=temp, seed=seed, **opts)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t) / (read_steps()["greedy"] - steps0)

    for temp, seed in ((0.0, SEED + 5), (0.6, SEED + 6)):
        got, ms_cap = timed_pass(tr.runner, temp, seed)
        ref, ms_eager = timed_pass(eager, temp, seed)
        d_lp = (got[1] - ref[1]).abs().max().item()
        d_ns = (got[3] - ref[3]).abs().max().item()
        same = bool(torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2]))
        print(f"transcribe (b) pass at T = {temp}: captured tokens "
              f"{'equal' if same else 'DIFFER FROM'} the eager runner's | max |d sum_logprobs| "
              f"{d_lp:.3e} (<= {CAPTURED_LOGPROB_TOL:g}) | max |d no_speech_prob| {d_ns:.3e} "
              f"(<= {CAPTURED_NO_SPEECH_TOL:g}) | scored {got[2].tolist()} | "
              f"{ms_cap:.3f} ms per step run captured, {ms_eager:.3f} eager (prep included)")
        if not same or d_lp > CAPTURED_LOGPROB_TOL or d_ns > CAPTURED_NO_SPEECH_TOL:
            fail(f"transcribe (b): the captured pass at T = {temp} differs from eager")
    if tr.runner.graph_stats()["programs"] != 1:
        fail("transcribe (b): the comparison passes made a second program")
    del eager, enc

    # (c) the conditioned loop: windows one after another, one program.
    with recording_transcribers() as made:
        _, wall_c, c, steps_c = counted(lambda: transcribe.run(
            cli(long_wav, "--condition_on_previous_text"), cfg, params, tok, device=device))
    tr_c = made[0]
    n_win = len(tr_c.infos)
    stats_c = tr_c.runner.graph_stats()
    n_seg = len(grid(tr_c.total, 32))
    print(f"transcribe (c) --condition_on_previous_text: {n_win} windows in {wall_c:.2f} s -> "
          f"RTFx {TRANSCRIBE_SECONDS / wall_c:.1f} | graphs {json.dumps(stats_c)} (one "
          f"program of up to {n_seg} segments, prompt buffer {tr_c.total - MAX_NEW_TOKENS}) | "
          f"steps {json.dumps({k: v for k, v in steps_c.items() if v})} | launches "
          f"{json.dumps({k: v for k, v in c.items() if v})}")
    want = {"encoder_attention_hm": cfg.encoder_layers * n_win, "fused_kv_init": n_win,
            "cross_decode_attention_exact": L * steps_c["greedy"]}
    if {k: c[k] for k in want} != want or n_win < 2:
        fail(f"transcribe (c): launches {c} over {n_win} windows, the design says {want}")
    check_counts("transcribe (c)", c, want_zero=tuple(k for k in KERNEL_NAMES if k not in want))
    if stats_c["programs"] != 1 or not 1 <= stats_c["graphs"] <= n_seg:
        fail(f"transcribe (c): {json.dumps(stats_c)} for one key over {n_win} windows")

    # (d) one window: beams with timestamps, the language detected.
    _, wall_d, c, _ = counted(lambda: transcribe.run(
        cli(short_wav, "--num_beams", str(BEAM_WIDTH), "--timestamps", "--language", "auto"),
        cfg, params, tok, device=device))
    check_counts("transcribe (d) beams", c, want_zero=KERNEL_NAMES)
    print(f"transcribe (d) --num_beams {BEAM_WIDTH} --timestamps --language auto: "
          f"{SINGLE_WINDOW_SECONDS} s in {wall_d:.2f} s -> RTFx "
          f"{SINGLE_WINDOW_SECONDS / wall_d:.1f} (its capture included) | no kernel")

    # (e) (b)'s group again with a q/v adapter: K4 in place of K2.
    g = torch.Generator(device=device).manual_seed(SEED + 13)
    lcfg = lora_lib.LoraConfig(r=LORA_RANK, alpha=LORA_ALPHA, dropout=0.0,
                               target_modules=("q_proj", "v_proj"))
    bank = lora_lib.map_with_path(
        lambda path, x: (torch.randn(x.shape, generator=g, device=device) * LORA_B_STD
                         if path[-1] == "b" else x),
        lora_lib.init_lora(g, cfg, lcfg, num_adapters=1))
    tr_e = fallback.FallbackTranscriber(
        cfg, params, tok, language="hindi", max_new_tokens=MAX_NEW_TOKENS, lora=bank,
        lora_scale=lcfg.scale, timestamps=True, best_of=TRANSCRIBE_BEST_OF, device=device)
    (_, info_e), wall_e, c, steps_e = counted(lambda: tr_e(feats, n_valid=windows))
    passes_e = fallback_passes(info_e[:windows], temps, TRANSCRIBE_BEST_OF)
    print(f"transcribe (e) a q/v adapter (r={LORA_RANK}): {wall_e:.2f} s, {passes_e} passes | "
          f"graphs {json.dumps(tr_e.runner.graph_stats())} | launches "
          f"{json.dumps({k: v for k, v in c.items() if v})}")
    want = {"encoder_attention_hm": cfg.encoder_layers, "fused_kv_init_lora": passes_e,
            "cross_decode_attention_exact": L * steps_e["greedy"]}
    if {k: c[k] for k in want} != want:
        fail(f"transcribe (e): launches {c}, the design says {want}")
    check_counts("transcribe (e)", c, want_zero=tuple(k for k in KERNEL_NAMES if k not in want))
    capture_s = sum(t.runner.graph_stats()["capture_s"] for t in (tr, tr_c, tr_e))
    print(f"transcribe: capture {capture_s:.2f} s over the fallback runners of (b), (c), (e)")

    # (f) two files through the CLI's default path: batch_transcribe's kept
    # program, which (a) captured, replayed for both.
    from sar_tpu_torch.evaluation import evaluator
    second_wav = work / "short2.wav"
    write_wav(second_wav, SINGLE_WINDOW_SECONDS, 16000, SEED + 15)
    plain = evaluator.plain_evaluator(cfg, params, cfg.prompt_ids("hindi"), MAX_NEW_TOKENS,
                                      device=device)
    before = plain.runner.graph_stats()
    args_f = transcribe.parse_args([str(short_wav), str(second_wav), "--model", cfg.name,
                                    "--language", "hindi", "--max_new_tokens",
                                    str(MAX_NEW_TOKENS), "--device", str(device)])
    texts_f, wall_f, c, _ = counted(lambda: transcribe.run(args_f, cfg, params, tok,
                                                           device=device))
    after = evaluator.plain_evaluator(cfg, params, cfg.prompt_ids("hindi"), MAX_NEW_TOKENS,
                                      device=device).runner.graph_stats()
    check_counts("transcribe (f) the default path", c, want_zero=KERNEL_NAMES)
    if len(texts_f) != 2 or after != before or before["graphs"] == 0:
        fail(f"transcribe (f): graphs {json.dumps(before)} before two files, "
             f"{json.dumps(after)} after")
    print(f"transcribe (f) the default path, two files of {SINGLE_WINDOW_SECONDS} s: "
          f"{wall_f:.2f} s ({wall_f / 2:.2f} s per file), no capture (the kept program of (a): "
          f"{json.dumps(after)}) | no kernel")
    return total


def stream_updates(audio_len: int, chunk_len: int, window: int) -> int:
    """The windows a StreamingTranscriber decodes when it is fed
    `audio_len` samples in chunks of `chunk_len`: one per feed, plus one
    per rollover (a window filled past `window` samples)."""
    held, windows = 0, 0
    for s in range(0, audio_len, chunk_len):
        held += min(chunk_len, audio_len - s)
        while held > window:
            held -= window
            windows += 1
        windows += 1
    return windows


# The wrappers of K1-K3 by the names the models module calls them by.
STREAM_KERNELS = ("encoder_attention_hm", "fused_kv_init", "cross_decode_attention_exact")


@contextlib.contextmanager
def recording_kernel_inputs(n_calls: int):
    """Copies of the inputs of the first `n_calls` calls of each of K1, K2
    and K3 that the models module makes inside the block, per wrapper name
    as (args, kwargs); every call goes on to the wrapper."""
    import torch
    from sar_tpu_torch.models import whisper
    calls = {name: [] for name in STREAM_KERNELS}
    wrappers = {name: getattr(whisper, name) for name in STREAM_KERNELS}

    def recorder(name):
        def call(*args, **kwargs):
            if len(calls[name]) < n_calls:
                copy = lambda x: x.clone() if isinstance(x, torch.Tensor) else x
                calls[name].append((tuple(copy(x) for x in args),
                                    {k: copy(v) for k, v in kwargs.items() if k != "out"}))
            return wrappers[name](*args, **kwargs)
        return call

    for name in STREAM_KERNELS:
        setattr(whisper, name, recorder(name))
    try:
        yield calls
    finally:
        for name, fn in wrappers.items():
            setattr(whisper, name, fn)


def check_recorded_kernels(label: str, calls: dict) -> dict:
    """Each recorded K1/K2/K3 call run again through its wrapper and its
    plain version, at phase_kernels' tolerances: K1 and K3 by max abs/rel
    error (K1 over the valid rows), K2 by `_kv_errors`. Returns the worst
    errors per kernel, with the batch the calls had."""
    from sar_tpu_torch.ops import decode_cross, flash_enc, kv_init
    plain = {"encoder_attention_hm": flash_enc.encoder_attention_hm_reference,
             "fused_kv_init": kv_init.fused_kv_init_reference,
             "cross_decode_attention_exact": decode_cross.cross_decode_reference_exact}
    kernel = {"encoder_attention_hm": flash_enc.encoder_attention_hm,
              "fused_kv_init": kv_init.fused_kv_init,
              "cross_decode_attention_exact": decode_cross.cross_decode_attention_exact}
    out = {}
    for name, recorded in calls.items():
        if not recorded:
            continue
        worst = [0.0, 0.0]
        for args, kwargs in recorded:
            got, want = kernel[name](*args, **kwargs), plain[name](*args, **kwargs)
            if name == "fused_kv_init":
                flip, scale_err, deq_err = _kv_errors(f"{label} {name}", got, want,
                                                      kwargs["t_valid"])
                errs = (deq_err, flip)
            else:
                if name == "encoder_attention_hm":
                    got, want = got[:, :kwargs["t_valid"]], want[:, :kwargs["t_valid"]]
                errs = _attn_errors(got, want)
                if errs[0] > ATTN_ABS_TOL or errs[1] > ATTN_REL_TOL:
                    fail(f"{label}: {name} at batch {args[0].shape[0]} disagrees with its "
                         f"plain version: {errs}")
            worst = [max(w, e) for w, e in zip(worst, errs)]
        out[name] = {"calls": len(recorded), "batch": recorded[0][0][0].shape[0],
                     "max_abs_err": worst[0],
                     ("flip_frac" if name == "fused_kv_init" else "max_rel_err"): worst[1]}
    return out


def phase_stream(cfg, params, device):
    """Streaming at whisper-small with phase 4's weights: a seeded random
    STREAM_SECONDS stream fed in STREAM_CHUNK_SECONDS chunks to a
    StreamingTranscriber at MAX_NEW_TOKENS, over the default unquantized
    cache (K1 only) and over the int8 cache (K1, K2, K3), each with the
    counters zeroed before the feeds and read after: K1 12 per decoded
    window (rollovers included), K2 one per window, K3 12 per step run;
    committed ids that never retract within a window; one program whose
    graphs are captured at the first update and replayed after; then the
    same chunks through an eager transcriber (capture=False), whose ids
    after every update equal the captured one's, and whose first update's
    K1/K2/K3 calls (batch 1) are each held against their plain versions
    (`check_recorded_kernels`). Prints ms per update
    (mean, p90; the replays), the streaming RTF and the capture seconds;
    returns the summed launch counts of the two captured runs."""
    import numpy as np
    import torch
    from sar_tpu_torch.data import CharTokenizer
    from sar_tpu_torch.decode.segments import grid
    from sar_tpu_torch.evaluation.streaming import StreamingTranscriber

    tok = CharTokenizer(cfg)
    sr = 16000
    audio = (np.random.default_rng(SEED + 14).standard_normal(STREAM_SECONDS * sr)
             * 0.1).astype(np.float32)
    step = STREAM_CHUNK_SECONDS * sr
    chunks = [audio[s:s + step] for s in range(0, len(audio), step)]
    total = dict.fromkeys(COUNTED_NAMES, 0)
    E, L = cfg.encoder_layers, cfg.decoder_layers
    for kv_int8 in (False, True):
        label = f"stream ({'int8' if kv_int8 else 'default'} cache)"
        make = lambda **kw: StreamingTranscriber(cfg, params, tok, language="hindi",
                                                 max_new_tokens=MAX_NEW_TOKENS,
                                                 kv_int8=kv_int8, device=device, **kw)
        st = make()
        if not st.capture or st.flash != "hm":
            fail(f"{label}: capture {st.capture}, flash {st.flash!r} on the card")
        windows = stream_updates(len(audio), step, st.window_samples)
        n_seg = len(grid(st._total, 32))
        snapshots, walls, graphs = [], [], []
        torch.cuda.synchronize()
        reset_counts()
        for chunk in chunks:
            held = len(st._audio)
            torch.cuda.synchronize()
            t = time.perf_counter()
            st.feed(chunk)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            snap = (list(st._committed), list(st._last_hyp), list(st._segments))
            if snapshots and held + len(chunk) <= st.window_samples:
                prev = snapshots[-1][0]
                if snap[0][:len(prev)] != prev:
                    fail(f"{label}: committed ids retracted at update {len(snapshots)}")
            snapshots.append(snap)
            graphs.append(st.runner.graph_stats())
        c, steps = read_counts(), read_steps()
        for k in total:
            total[k] += c[k]
        kind = "greedy" if kv_int8 else "classic"
        stats = graphs[-1]
        replays = sorted(walls[1:])
        mean = sum(replays) / len(replays)
        p90 = replays[int(0.9 * (len(replays) - 1))]
        text = st.finalize()
        print(f"{label}: {len(chunks)} updates of {STREAM_CHUNK_SECONDS} s, {windows} windows "
              f"decoded ({windows - len(chunks)} rolled over), {MAX_NEW_TOKENS} new tokens | ms per "
              f"update {1e3 * mean:.1f} mean, {1e3 * p90:.1f} p90 (the {len(replays)} replays) | "
              f"streaming RTF {STREAM_CHUNK_SECONDS / mean:.2f} | the first update "
              f"{1e3 * walls[0]:.1f} ms, capture {stats['capture_s']:.2f} s | graphs after the "
              f"first update {graphs[0]['graphs']}, at the end {stats['graphs']} (of {n_seg} "
              f"segments) | steps {json.dumps({k: v for k, v in steps.items() if v})} | "
              f"launches {json.dumps({k: v for k, v in c.items() if v})} | {len(text)} "
              f"characters")
        want = {"encoder_attention_hm": E * windows}
        if kv_int8:
            want.update(fused_kv_init=windows, cross_decode_attention_exact=L * steps[kind])
        if {k: c[k] for k in want} != want or steps[kind] == 0:
            fail(f"{label}: launches {c}, steps {steps}; the design says {want}")
        check_counts(label, c, want_zero=tuple(k for k in KERNEL_NAMES if k not in want))
        if steps[kind] > windows * (st._total - 1) or steps["host_syncs"] > windows * n_seg:
            fail(f"{label}: {steps} over {windows} windows of {st._total} positions")
        if stats["programs"] != 1 or not 1 <= stats["graphs"] <= n_seg or any(
                g["programs"] != 1 for g in graphs):
            fail(f"{label}: graphs {json.dumps(stats)} for one key ({n_seg} segments)")
        if graphs[0]["graphs"] == n_seg and stats["capture_s"] != graphs[0]["capture_s"]:
            fail(f"{label}: captured again after the first update")
        # The same chunks through an eager transcriber, not counted; the
        # kernels' inputs of its first update are recorded, and each call
        # is held against its plain version at the stream's batch of 1.
        eager = make(capture=False)
        with recording_kernel_inputs(max(E, L)) as calls:
            eager.feed(chunks[0])
        if {k for k, v in calls.items() if v} != set(want):
            fail(f"{label}: the first update called "
                 f"{ {k: len(v) for k, v in calls.items()} }, the design says {want}")
        errors = check_recorded_kernels(label, calls)
        del calls
        for i, chunk in enumerate(chunks):
            if i:
                eager.feed(chunk)
            if (eager._committed, eager._last_hyp, eager._segments) != snapshots[i]:
                fail(f"{label}: the eager transcriber's ids differ at update {i}")
        print(f"{label}: the eager transcriber's committed ids, hypothesis and segments "
              f"equal the captured one's after each of the {len(chunks)} updates | the first "
              f"update's kernel calls against their plain versions (tol {ATTN_ABS_TOL} abs, "
              f"{ATTN_REL_TOL} rel; K2 by int8 flips <= {KV_FLIP_FRAC_TOL}, scales "
              f"{KV_SCALE_REL_TOL}): {json.dumps(errors)}")
        del st, eager
    return total


def _wav_bytes(seconds: float, sr: int, channels: int, seed: int) -> bytes:
    """`seconds` of seeded 16-bit noise at `sr` Hz."""
    import wave

    import numpy as np
    samples = np.random.default_rng(seed).standard_normal(int(seconds * sr) * channels) * 3000
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(samples.astype(np.int16).tobytes())
    return buf.getvalue()


def _http(base: str, path: str, data: bytes | None = None) -> tuple[int, dict, float]:
    """(status, JSON body, round-trip ms) of one request."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(base + path, data=data,
                                 method="GET" if data is None else "POST")
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            code, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, body = e.code, json.loads(e.read())
    return code, body, 1e3 * (time.perf_counter() - t)


def phase_serve(cfg, params, device, work):
    """The HTTP server (sar_tpu_torch.scripts.serve) at whisper-small with
    phase 4's weights: `build_service` + `make_server` on 127.0.0.1:0 with
    --kv_cache int8 --batch_size 8, then a routed server from the route
    phase's saved adapters and the lid phase's head. Per server: one
    warm-up POST (the capture), then with the counters zeroed SERVE_CLIENTS
    concurrent POSTs of SERVE_SECONDS s WAVs at 16 kHz, one
    SERVE_RESAMPLE_SECONDS s stereo WAV at 44.1 kHz (the resample path),
    /healthz, /stats, a bad WAV (400) and an unknown path (404); every
    response's text equal to the service's own transcription of the audio
    wav_bytes_to_audio decodes from the same bytes; the plain server's
    launches K1 12 and K2 1 per batch, K3 12 per step, the routed one's K1
    (LID_LAYER + 1 + 12) and K4 1 per batch, K3 12 per step; the routed
    responses carry a detected language. Prints the round-trip p50/p95 and
    the batches per request; returns the summed launch counts."""
    import threading

    import torch
    from sar_tpu_torch.data import CharTokenizer
    from sar_tpu_torch.models.config import TARGET_LANGUAGES
    from sar_tpu_torch.scripts import serve

    work = Path(work)
    tok = CharTokenizer(cfg)
    total = dict.fromkeys(COUNTED_NAMES, 0)
    E, L = cfg.encoder_layers, cfg.decoder_layers
    langs = list(TARGET_LANGUAGES)
    bodies = [_wav_bytes(SERVE_SECONDS, 16000, 1, SEED + 20 + i) for i in range(SERVE_CLIENTS)]
    resampled = _wav_bytes(SERVE_RESAMPLE_SECONDS, 44100, 2, SEED + 30)
    common = ["--model", cfg.name, "--language", "hindi", "--kv_cache", "int8", "--batch_size",
              str(BATCH), "--max_wait_ms", str(SERVE_WAIT_MS), "--max_new_tokens",
              str(MAX_NEW_TOKENS), "--device", str(device)]
    routed_flags = ["--classifier", str(work / "lid"), "--adapters",
                    *(f"{l}={work / 'adapters' / l}" for l in langs)]
    for label, flags in (("serve", []), ("serve routed", routed_flags)):
        routed = bool(flags)
        svc = serve.build_service(serve.parse_args(common + flags), cfg, params, tok)
        server = serve.make_server(svc, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = "http://%s:%d" % server.server_address
        try:
            code, _, warm_ms = _http(base, "/v1/transcribe", bodies[0])
            if code != 200:
                fail(f"{label}: the warm-up POST returned {code}")
            warm = svc.stats()
            graphs = (svc.router if routed else svc._ev).runner.graph_stats()
            torch.cuda.synchronize()
            reset_counts()
            out = [None] * SERVE_CLIENTS

            def client(i):
                out[i] = _http(base, "/v1/transcribe?language=hindi", bodies[i])

            threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            burst_s = time.perf_counter() - t
            burst = svc.stats()
            out.append(_http(base, "/v1/transcribe", resampled))
            checks = {"/healthz": _http(base, "/healthz"), "/stats": _http(base, "/stats"),
                      "bad wav": _http(base, "/v1/transcribe", b"RIFF nonsense"),
                      "/nope": _http(base, "/nope")}
            torch.cuda.synchronize()
            c, steps = read_counts(), read_steps()
            final = svc.stats()
            # The service's own transcription of the same decoded audio (not
            # counted: the counts above are the HTTP requests').
            for i, (code, body, _) in enumerate(out):
                data = resampled if i == SERVE_CLIENTS else bodies[i]
                want = svc.transcribe(serve.wav_bytes_to_audio(data), timeout=600)
                if code != 200 or set(body) != {"text", "language", "seconds", "latency_ms"}:
                    fail(f"{label}: request {i} returned {code} {body}")
                if body["text"] != want:
                    fail(f"{label}: request {i}'s text differs from the service's own")
                if routed and body["language"] not in langs:
                    fail(f"{label}: request {i} detected {body['language']!r}")
        finally:
            server.shutdown()
            server.server_close()
            svc.close()
        want_codes = {"/healthz": 200, "/stats": 200, "bad wav": 400, "/nope": 404}
        if {k: v[0] for k, v in checks.items()} != want_codes or checks["/healthz"][1] != {"ok": True}:
            fail(f"{label}: {json.dumps({k: v[:2] for k, v in checks.items()})}")
        if checks["/stats"][1]["requests"] != warm["requests"] + SERVE_CLIENTS + 1:
            fail(f"{label}: /stats says {checks['/stats'][1]}")
        for k in total:
            total[k] += c[k]
        batches = final["batches"] - warm["batches"]
        trips = sorted(o[2] for o in out[:SERVE_CLIENTS])
        p50, p95 = trips[len(trips) // 2], trips[min(len(trips) - 1, int(0.95 * len(trips)))]
        print(f"{label}: warm-up POST {warm_ms:.0f} ms (capture {graphs['capture_s']:.2f} s, "
              f"{graphs['graphs']} graphs); {SERVE_CLIENTS} concurrent "
              f"POSTs of {SERVE_SECONDS} s in {burst_s:.2f} s, round trip p50 {p50:.1f} ms, "
              f"p95 {p95:.1f} ms, {burst['batches'] - warm['batches']} batches for "
              f"{SERVE_CLIENTS} requests ({(burst['batches'] - warm['batches']) / SERVE_CLIENTS:.3f} "
              f"per request) | a {SERVE_RESAMPLE_SECONDS} s stereo 44.1 kHz POST {out[-1][2]:.1f} ms "
              f"| languages {sorted({str(o[1]['language']) for o in out})} | steps "
              f"{json.dumps({k: v for k, v in steps.items() if v})} | launches "
              f"{json.dumps({k: v for k, v in c.items() if v})} | texts equal the service's own")
        lid = LID_LAYER + 1 if routed else 0
        want = {"encoder_attention_hm": (E + lid) * batches,
                "fused_kv_init_lora" if routed else "fused_kv_init": batches,
                "cross_decode_attention_exact": L * steps["greedy"]}
        if {k: c[k] for k in want} != want or steps["greedy"] == 0:
            fail(f"{label}: launches {c} over {batches} batches, the design says {want}")
        check_counts(label, c, want_zero=tuple(k for k in KERNEL_NAMES if k not in want))
    return total


def phase_mesh(cfg, params, device):
    """The device-mesh path (sar_tpu_torch/parallel) at whisper-small on a
    NCCL group of one rank (a localhost rendezvous) and make_mesh(1, 1):
    ASRTrainer, ASREvaluator and LIDTrainer each with mesh= against the
    same run without one; returns the launch counts of the mesh runs."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    from sar_tpu_torch.data import (DataLoader, LIDCollator, SyntheticASRDataset,
                                    create_collator)
    from sar_tpu_torch.decode.graphs import CudaGraphCapture, DecodeRunner
    from sar_tpu_torch.decode.greedy import transcribe_tokens
    from sar_tpu_torch.evaluation import ASREvaluator
    from sar_tpu_torch.models import classifier as clf
    from sar_tpu_torch.models import lora as lora_lib
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.models.config import TARGET_LANGUAGES
    from sar_tpu_torch.ops import mel as mel_ops
    from sar_tpu_torch.parallel import distributed as pdist
    from sar_tpu_torch.parallel import sharding
    from sar_tpu_torch.training import ASRTrainer, TrainingArgs
    from sar_tpu_torch.training.lid_trainer import LIDDataset, LIDTrainer, LIDTrainingArgs

    t_phase = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if not pdist.maybe_initialize_distributed(f"127.0.0.1:{port}", 1, 0):
        fail("mesh: the process group did not start")
    try:
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            fail(f"mesh: backend {dist.get_backend()}, world {dist.get_world_size()}")
        mesh = sharding.make_mesh(1, 1)
        if sharding.model_group(mesh) is not None or pdist.n_batch_shards(mesh) != 1:
            fail("mesh: a 1 x 1 mesh has collectives")
        print(f"mesh: NCCL world of {dist.get_world_size()} on "
              f"{sharding.mesh_device(mesh)}, axes {pdist.axis_sizes(mesh)} (two ranks "
              f"cannot share the one card under NCCL: world > 1 runs in the CPU tests "
              f"over gloo, tests/test_torch_parallel.py)")
        total = dict.fromkeys(COUNTED_NAMES, 0)

        def add(c):
            for k in total:
                total[k] += c[k]

        # (a) ASRTrainer: the train cell's shape, without evaluation.
        coll = create_collator(cfg.sot_token_id, pad_to_length=TRAIN_LABEL_LEN,
                               num_mels=cfg.num_mel_bins, num_frames=cfg.num_audio_frames,
                               device=device)
        lcfg = lora_lib.LoraConfig(r=LORA_RANK, alpha=LORA_ALPHA, dropout=0.1,
                                   target_modules=("q_proj", "v_proj"))

        def train(m):
            loader = DataLoader(SyntheticASRDataset(cfg, size=2 * BATCH, language="english",
                                                    seed=SEED), BATCH, coll, seed=SEED)
            bank = lora_lib.init_lora(torch.Generator(device=device).manual_seed(SEED + 4),
                                      cfg, lcfg)
            tr = ASRTrainer(cfg, params, bank, lcfg, TrainingArgs(
                learning_rate=5e-4, warmup_steps=1, max_steps=MESH_TRAIN_STEPS, eval_steps=0,
                gradient_accumulation_steps=TRAIN_ACCUM, seed=SEED, device=str(device)),
                mesh=m)
            torch.cuda.synchronize()
            reset_counts()
            hist = tr.train(loader)
            torch.cuda.synchronize()
            return hist, tr.lora, read_counts()

        # Meshless first: what warming up is left after the first step
        # (which the medians drop) falls on it.
        (h_p, bank_p, _) = train(None)
        (h_m, bank_m, c_m) = train(mesh)
        add(c_m)
        d_bank = max(float((a - b).detach().abs().max()) for a, b in
                     zip(whisper.tree_leaves(bank_m), whisper.tree_leaves(bank_p)))
        d_loss = max(abs(a - b) / abs(b) for a, b in zip(h_m["loss"], h_p["loss"]))
        ms = [1e3 * statistics.median(h["step_seconds"][1:]) for h in (h_m, h_p)]
        n_attn = cfg.encoder_layers + 2 * cfg.decoder_layers
        want = MESH_TRAIN_STEPS * TRAIN_ACCUM * n_attn
        print(f"mesh train: {MESH_TRAIN_STEPS} steps of {BATCH} x {TRAIN_ACCUM}, labels "
              f"{TRAIN_LABEL_LEN} | losses mesh "
              f"{', '.join(f'{x:.6f}' for x in h_m['loss'])} vs meshless "
              f"{', '.join(f'{x:.6f}' for x in h_p['loss'])} (max rel diff {d_loss:.2e}) | "
              f"bank max |diff| {d_bank:.2e} | {ms[0]:.1f} ms per step mesh vs {ms[1]:.1f} "
              f"meshless (median after the first) | launches "
              f"{json.dumps({k: v for k, v in c_m.items() if v})}")
        if d_loss > MESH_REL_TOL or d_bank > MESH_ABS_TOL:
            fail("mesh train: the mesh trainer differs from the meshless one")
        if (c_m["flash_attention_fwd"], c_m["flash_attention_bwd_dq"],
                c_m["flash_attention_bwd_dkv"]) != (want, want, want):
            fail(f"mesh train: K6 launches {c_m}, the design says {want} each "
                 f"({n_attn} per microbatch)")
        check_counts("mesh train", c_m, want_zero=tuple(k for k in KERNEL_NAMES
                                                        if k not in K6_NAMES))

        # (b) ASREvaluator over the greedy cell's clips: the classic int8
        # cache (no K2/K3), captured; a meshless runner over the same cache.
        g = torch.Generator(device=device).manual_seed(SEED + 1)
        feats = [mel_ops.log_mel_spectrogram(
            torch.randn((BATCH, mel_ops.N_SAMPLES), generator=g, device=device) * 0.1,
            cfg.num_mel_bins, dtype=torch.bfloat16)[:, :, :cfg.num_audio_frames]
            for _ in range(N_BATCHES)]
        ev = ASREvaluator(cfg, params, language="hindi", max_new_tokens=MAX_NEW_TOKENS,
                          device=device, mesh=mesh)
        if not ev.capture or ev.flash != "hm" or ev._flags.get("head_minor") is not False:
            fail(f"mesh evaluator: capture {ev.capture}, flash {ev.flash!r}, "
                 f"cache {ev._flags}")
        P = int(ev._prompt.shape[0])
        runner = DecodeRunner(params, cfg, capture=CudaGraphCapture)

        def meshless(f):
            enc = whisper.encode(params, f, cfg, flash="hm")
            cache = runner.prep(enc, ev.total, head_minor=False, **INT8)
            return transcribe_tokens(runner.greedy(cache, ev._prompt), cfg, prompt_len=P)

        def fenced(fn, f):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(f)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t

        ev._transcribe_batch(feats[0])                 # warm-up: the capture
        meshless(feats[0])
        reset_counts()
        got = [fenced(ev._transcribe_batch, f) for f in feats]
        c_e, steps = read_counts(), read_steps()
        add(c_e)
        want_ids = [fenced(meshless, f) for f in feats]
        same = all(a[0] == b[0] for a, b in zip(got, want_ids))
        part = ev._transcribe_batch(feats[0][:MESH_PARTIAL])
        same_part = part == meshless(feats[0][:MESH_PARTIAL])
        n_tok = sum(len(r) for o in got for r in o[0])
        print(f"mesh eval: {N_BATCHES} x {BATCH} clips, {MAX_NEW_TOKENS} new tokens, the "
              f"classic int8 cache, captured | ids {'equal' if same else 'DIFFER'} to the "
              f"meshless runner's | partial batch of {MESH_PARTIAL} "
              f"{'equal' if same_part else 'DIFFERS'} | {n_tok} tokens kept | ms per batch "
              f"mesh {', '.join(f'{1e3 * o[1]:.1f}' for o in got)} vs meshless "
              f"{', '.join(f'{1e3 * o[1]:.1f}' for o in want_ids)} | steps "
              f"{json.dumps(steps)} | launches {json.dumps({k: v for k, v in c_e.items() if v})}")
        if not (same and same_part):
            fail("mesh eval: the mesh evaluator's ids differ from the meshless runner's")
        if c_e["encoder_attention_hm"] != cfg.encoder_layers * N_BATCHES or steps["classic"] < 1:
            fail(f"mesh eval: K1 {c_e['encoder_attention_hm']} (the design says "
                 f"{cfg.encoder_layers} per batch), classic steps {steps['classic']}")
        check_counts("mesh eval", c_e, want_zero=tuple(k for k in KERNEL_NAMES
                                                       if k != "encoder_attention_hm"))

        # (c) LIDTrainer (exact encoder attention under a mesh, as JAX's).
        langs = tuple(TARGET_LANGUAGES)
        ds = LIDDataset({l: SyntheticASRDataset(cfg, size=BATCH, language=l, language_id=i,
                                                seed=i) for i, l in enumerate(langs)}, langs)
        ccfg = clf.ClassifierConfig(input_dim=cfg.d_model, hidden_dims=(256, 128),
                                    num_classes=len(langs), dropout=0.1, pooling="mean",
                                    languages=langs, encoder_layer=LID_LAYER)
        head = clf.init_classifier(torch.Generator(device=device).manual_seed(SEED + 6), ccfg)

        def lid(m):
            tr = LIDTrainer(cfg, params, head, ccfg, LIDTrainingArgs(
                learning_rate=1e-3, warmup_steps=1, max_steps=MESH_LID_STEPS, eval_steps=0,
                encoder_layer=LID_LAYER, seed=SEED, device=str(device)), mesh=m)
            tr.flash = False          # the meshless run on the mesh's attention
            loader = DataLoader(ds, BATCH, LIDCollator(num_mels=cfg.num_mel_bins,
                                                       num_frames=cfg.num_audio_frames),
                                seed=SEED)
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            hist = tr.train(loader)
            torch.cuda.synchronize()
            return hist["loss"], (time.perf_counter() - t) / MESH_LID_STEPS, read_counts()

        lid(None)                     # warm-up (the exact attention's buffers)
        (l_m, s_m, c_l), (l_p, s_p, _) = lid(mesh), lid(None)
        add(c_l)
        d_lid = max(abs(a - b) / abs(b) for a, b in zip(l_m, l_p))
        print(f"mesh lid: {MESH_LID_STEPS} streaming steps of {BATCH} at layer {LID_LAYER} | "
              f"losses mesh {', '.join(f'{x:.6f}' for x in l_m)} vs meshless "
              f"{', '.join(f'{x:.6f}' for x in l_p)} (max rel diff {d_lid:.2e}) | "
              f"{1e3 * s_m:.1f} ms per step mesh vs {1e3 * s_p:.1f} meshless | launches "
              f"{json.dumps({k: v for k, v in c_l.items() if v})}")
        if d_lid > MESH_REL_TOL or not np.isfinite(l_m).all():
            fail("mesh lid: the mesh trainer differs from the meshless one")
        check_counts("mesh lid", c_l, want_zero=KERNEL_NAMES)
        print(f"mesh: {time.perf_counter() - t_phase:.1f} s | launches "
              f"{json.dumps({k: v for k, v in total.items() if v})}")
        return total
    finally:
        dist.destroy_process_group()


# The mixed-precision caches, (cross, self) precisions -> init_cache's flags;
# the int4 flag wins over its side's int8 flag (the (int8, int4) and (int4,
# int8) flags pass both).
MIXED_PAIRS = {
    ("plain", "int8"): dict(self_kv_int8=True),
    ("plain", "int4"): dict(self_kv_int4=True),
    ("int8", "plain"): dict(cross_kv_int8=True),
    ("int8", "int4"): dict(cross_kv_int8=True, self_kv_int8=True, self_kv_int4=True),
    ("int4", "plain"): dict(cross_kv_int4=True),
    ("int4", "int8"): dict(cross_kv_int8=True, cross_kv_int4=True, self_kv_int8=True),
}
MIXED_BEAM_PAIRS = (("int8", "plain"), ("int8", "int4"))


def phase_mixed(cfg, params, device, batch, max_new_tokens):
    """The mixed-precision decode caches at whisper-small, batch `batch`,
    30 s clips (the greedy cell's), `max_new_tokens`: for each of the six
    (cross, self) pairs whose sides differ (MIXED_PAIRS), one encode (K1)
    and the cache, then the eager greedy loop (greedy_decode_from_cache)
    with the counters zeroed before and read after (K1 12, K11 12 per step
    on an int8 self side, no other kernel: the classic layout reads the
    rest in plain torch; the classic steps and host syncs those the tokens
    predict), then the same through one DecodeRunner with CUDA graphs (its
    capture pass first, uncounted; then prep + replay: K11 as eager, the
    same steps), tokens equal; ms per
    token-step of each and the cache's bytes. Then beams of BEAM_WIDTH for
    MIXED_BEAM_PAIRS (ancestry and physical reorder), one encode (K1 12)
    and eager beam_decode against the runner's captured beam, tokens equal.
    Returns the launch counts of the counted runs."""
    import torch
    from sar_tpu_torch.decode import beam_decode
    from sar_tpu_torch.decode.graphs import CudaGraphCapture, DecodeRunner
    from sar_tpu_torch.decode.greedy import greedy_decode_from_cache
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.ops import mel as mel_ops

    t_phase = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(SEED + 1)      # the greedy cell's clips
    feats = mel_ops.log_mel_spectrogram(
        torch.randn((batch, mel_ops.N_SAMPLES), generator=g, device=device) * 0.1,
        cfg.num_mel_bins, dtype=torch.bfloat16)[:, :, :cfg.num_audio_frames]
    prompt = cfg.prompt_ids("hindi")
    P = len(prompt)
    total = min(P + max_new_tokens, cfg.max_target_positions)
    K = BEAM_WIDTH
    card = card_line()
    total_counts = dict.fromkeys(COUNTED_NAMES, 0)
    runner = DecodeRunner(params, cfg, capture=CudaGraphCapture)

    def fenced(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def counted(label, fn, want_k1, k11_per_step=0):
        """fn() with the counters zeroed before and read after: K1 at
        `want_k1`, K11 at `k11_per_step` per classic step run, K13 and K14
        at their counts per step, no other kernel."""
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        c, st = read_counts(), read_steps()
        for k in COUNTED_NAMES:
            total_counts[k] += c[k]
        if c["encoder_attention_hm"] != want_k1 or any(
                v for k, v in c.items()
                if k not in ("encoder_attention_hm", K11_NAME, *LN_NAMES)):
            fail(f"{label}: launches {json.dumps({k: v for k, v in c.items() if v})}, the "
                 f"design says K1 = {want_k1} and no other kernel but K11, K13 and K14")
        if any(st[k] for k in ("greedy", "beam", "s8")):
            fail(f"{label}: steps {st}: a mixed cache's steps are classic ones")
        check_k11(label, c, k11_per_step * st["classic"])
        check_ln(label, c, cfg.decoder_layers, st["classic"])
        return out, st

    for pair, flags in MIXED_PAIRS.items():
        label = f"mixed {pair[0]}/{pair[1]}"
        if whisper.cache_kind(**flags) != "/".join(pair):
            fail(f"{label}: the flags ask for the {whisper.cache_kind(**flags)} cache")

        def eager():
            enc = whisper.encode(params, feats, cfg, flash="hm")
            cache = whisper.init_cache(params, enc, cfg, total, **flags)
            return enc, cache, fenced(lambda: greedy_decode_from_cache(params, cache, cfg,
                                                                       prompt))

        # An int8 self side goes through K11 (12 per step); an int4 or
        # plain one through plain torch.
        k11 = cfg.decoder_layers if pair[1] == "int8" else 0
        (enc, cache, (tok_e, s_e)), st_e = counted(f"{label} eager", eager, cfg.encoder_layers,
                                                   k11)
        nbytes = sum(x.numel() * x.element_size() for x in cache if x is not None)
        cross_b = sum(x.numel() * x.element_size() for x in
                      (cache.cross_k, cache.cross_v, cache.cross_k_scale, cache.cross_v_scale)
                      if x is not None)
        del cache

        def replay():
            cache = runner.prep(enc, total, **flags)
            return fenced(lambda: runner.greedy(cache, prompt))

        replay()                                                     # the capture pass
        (tok_c, s_c), st_c = counted(f"{label} captured", replay, 0, k11)
        check_captured_equals_eager(label, tok_c, tok_e)
        needed, run = decode_steps(tok_e, cfg, P)
        for name, st in (("eager", st_e), ("captured", st_c)):
            if st["classic"] != run or st["host_syncs"] != segments_run(total, run):
                fail(f"{label} {name}: {st['classic']} classic steps and {st['host_syncs']} "
                     f"host syncs, the tokens predict {run} and {segments_run(total, run)}")
        gs = runner.graph_stats()
        print(f"{label}: batch {batch}, {max_new_tokens} new tokens, {run} steps run "
              f"({needed} needed) | ms per token-step eager {1e3 * s_e / run:.3f}, captured "
              f"{1e3 * s_c / run:.3f} | cache "
              f"{nbytes / 1e6:.1f} MB (cross {cross_b / 1e6:.1f} MB) | graphs {gs['graphs']}, "
              f"capture {gs['capture_s']:.2f} s | {card}")

    for pair in MIXED_BEAM_PAIRS:
        label, flags = f"mixed beam {K} {pair[0]}/{pair[1]}", MIXED_PAIRS[pair]

        def eager():
            enc = whisper.encode(params, feats, cfg, flash="hm")
            return enc, fenced(lambda: beam_decode(params, enc, cfg, prompt, num_beams=K,
                                                   max_new_tokens=max_new_tokens, **flags))

        (enc, (tok_e, s_e)), st_e = counted(f"{label} eager", eager, cfg.encoder_layers)

        def captured():
            cache = runner.prep(enc, total, self_batch=batch * K, **flags)
            return runner.beam(cache, prompt, num_beams=K)

        captured()                                                   # the capture pass
        (tok_c, s_c), st_c = counted(f"{label} captured", lambda: fenced(captured), 0)
        check_captured_equals_eager(label, tok_c, tok_e)
        if st_c["classic"] != st_e["classic"] or st_c["host_syncs"] != st_e["host_syncs"]:
            fail(f"{label}: captured steps {st_c}, eager {st_e}")
        steps = st_e["classic"]
        reads = "physically reordered" if pair[1] == "int4" else "through the ancestry"
        print(f"{label}: batch {batch} x {K} beams, {steps} steps run | ms per token-step "
              f"eager {1e3 * s_e / steps:.3f}, captured {1e3 * s_c / steps:.3f} (each with "
              f"its cache build) | self reads {reads} | {card}")
    print(f"mixed: {time.perf_counter() - t_phase:.1f} s | launches "
          f"{json.dumps({k: v for k, v in total_counts.items() if v})}")
    return total_counts


def phase_owsm(device) -> dict:
    """OWSM_MODEL through ASREvaluator.from_audio at its published widths
    (the module docstring's phase 20)."""
    import dataclasses

    import numpy as np
    import torch

    from benchmarks import weights_owsm
    from sar_tpu_torch.evaluation import ASREvaluator
    from sar_tpu_torch.models import ebranchformer, whisper
    from sar_tpu_torch.models.config import get_config

    cfg = get_config(OWSM_MODEL)
    t0 = time.perf_counter()
    params = whisper.cast_params(ebranchformer.port_params(
        weights_owsm.make(dataclasses.asdict(cfg), SEED, device), cfg), torch.bfloat16)
    rng = np.random.default_rng(SEED + 20)
    batches = []
    for i in range(1 + OWSM_BATCHES):
        secs = rng.uniform(*OWSM_SECONDS, OWSM_BATCH)
        clips = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32) for s in secs]
        langs = [cfg.languages[(i * OWSM_BATCH + r) % len(cfg.languages)]
                 for r in range(OWSM_BATCH)]
        prompts = torch.tensor([cfg.prompt_ids(code) for code in langs], device=device)
        batches.append((clips, prompts, float(secs.sum())))
    ev = ASREvaluator(cfg, params, None, language="hindi", max_new_tokens=OWSM_NEW_TOKENS,
                      kv_int8=True, flash="auto", device=device)
    if ev.flash != "hm" or not ev.capture:
        fail(f"the OWSM evaluator took flash={ev.flash!r}, capture={ev.capture}: "
             f"want the kernel encoder and the captured loop")
    P, total = len(cfg.prompt_ids("hindi")), ev.total
    tokens = []
    run_tokens = ev.tokens

    def recorded(mel, prompts=None):
        tokens.append(run_tokens(mel, prompts))
        return tokens[-1]
    ev.tokens = recorded
    ev.from_audio(*batches[0][:2])            # warm-up: capture, cuBLAS, cuDNN, allocator
    torch.cuda.synchronize()
    print(f"owsm setup: {cfg.name} random bf16 weights "
          f"({whisper.param_count(params) / 1e6:.1f} M params) + the warm-up batch of "
          f"{OWSM_BATCH} clips, {time.perf_counter() - t0:.1f} s")
    tokens.clear()
    reset_counts()
    outs, wall, audio_s = [], 0.0, 0.0
    for clips, prompts, secs in batches[1:]:
        t = time.perf_counter()
        outs.append(ev.from_audio(clips, prompts))
        torch.cuda.synchronize()
        wall += time.perf_counter() - t
        audio_s += secs
    counts, run_steps = read_counts(), read_steps()
    steps = [decode_steps(tk, cfg, P)[1] for tk in tokens]
    syncs = sum(segments_run(total, st) for st in steps)
    print(f"owsm (captured): {OWSM_BATCHES} x {OWSM_BATCH} clips, {audio_s:.1f} audio-s in "
          f"{wall:.3f} s -> RTFx {audio_s / wall:.1f} | steps {json.dumps(run_steps)} | "
          f"launches {json.dumps(counts)}")
    Le, Ld, n = cfg.encoder_layers, cfg.decoder_layers, OWSM_BATCHES
    want = {"depthwise_conv_time": 2 * Le * n, "encoder_attention_hm": Le * n,
            "fused_kv_init": n}
    check_ln("owsm", counts, Ld, run_steps["greedy"], encoder_k13=(6 * Le + 1) * n)
    print(f"owsm: K12, K1, K2 launched "
          f"{[counts[k] for k in want]} times (the design: {list(want.values())})")
    if any(counts[k] != v for k, v in want.items()):
        fail(f"owsm: launches {[counts[k] for k in want]}, the design {list(want.values())}")
    check_counts("owsm", counts, want_zero=tuple(
        k for k in KERNEL_NAMES if k not in (*want, "cross_decode_attention_exact")))
    check_steps("owsm", counts, run_steps, sum(steps), syncs, "cross_decode_attention_exact", Ld)
    check_k11("owsm", counts, Ld * run_steps["greedy"])
    check_k3_form("owsm", counts, OWSM_BATCH, cfg.decoder_heads,
                  whisper.cross_pad_len(cfg.max_source_positions))
    eager = ASREvaluator(cfg, params, None, language="hindi", max_new_tokens=OWSM_NEW_TOKENS,
                         kv_int8=True, flash="auto", device=device, capture=False)
    same = eager.from_audio(*batches[1][:2]) == outs[0]
    print(f"owsm: captured ids {'equal' if same else 'DIFFER FROM'} the eager loop's "
          f"(batch of {OWSM_BATCH})")
    if not same:
        fail("owsm: the captured decode's ids differ from the eager loop's")
    del ev, eager, params
    return counts


def path_phases(cfg, params, n_params, device, work, profile=False) -> list:
    """The phases that drive a path, in order, as (name, run) pairs; `work`
    is a scratch directory (the lid phase's head, which the route phase
    reads; the sweep's report; the route phase's adapters and router)."""
    return [("greedy", lambda: phase_e2e(cfg, params, n_params, device, BATCH, N_BATCHES,
                                         MAX_NEW_TOKENS)),
            ("routed", lambda: phase_routed(cfg, params, device, BATCH, MAX_NEW_TOKENS,
                                            profile=profile)),
            ("beam", lambda: phase_beam(cfg, params, device, BATCH, MAX_NEW_TOKENS,
                                        profile=profile)),
            ("train", lambda: phase_train(cfg, params, device, BATCH, profile=profile)),
            ("s8", lambda: phase_s8(cfg, params, device, BATCH, N_BATCHES, MAX_NEW_TOKENS,
                                    profile=profile)),
            ("fq", lambda: phase_fq(cfg, params, device, BATCH, N_BATCHES, MAX_NEW_TOKENS)),
            ("bench", lambda: phase_bench(cfg, device)),
            ("graphs", lambda: phase_graphs(cfg, params, device, BATCH, profile=profile)),
            ("lid", lambda: phase_lid(cfg, params, device, Path(work) / "lid")),
            ("sweep", lambda: phase_sweep(cfg, device, work)),
            ("route", lambda: phase_route(cfg, params, device, work)),
            ("transcribe", lambda: phase_transcribe(cfg, params, device, work)),
            ("stream", lambda: phase_stream(cfg, params, device)),
            ("serve", lambda: phase_serve(cfg, params, device, work)),
            ("mesh", lambda: phase_mesh(cfg, params, device)),
            ("mixed", lambda: phase_mixed(cfg, params, device, BATCH, MAX_NEW_TOKENS)),
            ("owsm", lambda: phase_owsm(device))]


def main() -> int:
    device, name, _ = phase_device()
    import torch
    from sar_tpu_torch.models.config import get_config
    phase_build()
    cfg = get_config(MODEL)
    params, n_params = make_model(cfg, device)
    t0 = time.perf_counter()
    rows = (phase_kernels(cfg, device, BATCH) + phase_k6(cfg, device, BATCH)
            + phase_kernels_k8_k10(cfg, params, device, BATCH) + phase_k12_k13(device)
            + phase_k14(device))
    print(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shapes", "extra")
    if "--kernels-only" in sys.argv[1:]:
        # The kernel table alone: no path is driven, so no launch counts and
        # no result line.
        print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in rows]}))
        return 0
    profile = "--profile" in sys.argv[1:]
    by_path = {}
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch, prefix="chip_smoke_") as work:
        for phase, run in path_phases(cfg, params, n_params, device, work, profile):
            t0 = time.perf_counter()
            counts = run()
            # phase_fq returns its counts by path (fq, fq_lora, beam_default).
            by_path.update(counts if phase == "fq" else {phase: counts})
            print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
