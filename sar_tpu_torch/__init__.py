"""sar_tpu_torch — the PyTorch + CUDA port of sar_tpu for NVIDIA Hopper.

The JAX package `sar_tpu` stays the reference; this package mirrors its
module paths (`sar_tpu_torch/models/whisper.py` is the counterpart of
`sar_tpu/models/whisper.py`) and never imports jax or sar_tpu.

Covered so far: the int8-KV greedy transcription path — log-mel frontend,
Whisper encoder (head-minor attention kernel), the int8 head-minor decode
cache (fused projection + quantization kernel), the KV-cached decode step
(cross-attention decode kernel), the greedy loop and the evaluator's
greedy prep/decode pair — and the routed multi-adapter serving path: LoRA
banks (models/lora.py, the PEFT import in models/convert.py), the LID
classifier (models/classifier.py), the AdapterRouter (models/router.py)
and the micro-batching TranscriptionService (serving/service.py), whose
cache build adds each utterance's cross_v LoRA term in the fused kernel's
LoRA variant — and beam search with the evaluation workload: beam_decode
(decode/beam.py; the K beam queries of a sample share one read of its
cross slab in the beam-folded decode kernel), ASREvaluator.evaluate with
corpus WER/CER (training/metrics.py), the synthetic data pipeline
(data/) and the evaluate CLI (scripts/evaluate_model.py) — and LoRA
training: the teacher-forced forward with checkpointed layers and LoRA
dropout (models/whisper.py), every attention of a step through the
blockwise flash-attention kernels, forward and backward (ops/flash.py),
ASRTrainer with the optax-equivalent clipped AdamW, checkpoints and
callbacks (training/), WhisperLoRA (models/whisper_lora.py) and the train
CLI (scripts/train_lora.py) — and the opt-ins: the quantized decode (s8
attention scores, the int4 cache) and the fused encoder
(encode(flash="fq"): pre-LN + q/k/v projections + attention in one entry
point, ops/flash_enc.py); ops/attic/ holds the JAX package's two parked
decode kernels, standalone. The decode functions default, as JAX's do,
to the unquantized classic cache; the serving programs ask for the int8
one. Entry points run on the CUDA card unless
given device="cpu" (device.py). The kernels are hand-written CUDA C++ for
sm_90a (`csrc/`), built at first use by `ops/_build.py`; every kernel has
a plain PyTorch version beside it that CPU tensors take.
"""

__version__ = "0.1.0"
