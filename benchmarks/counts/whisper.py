"""Operations and bytes that Whisper's kernels and steps need, from shapes.

Each count is what the inputs need, whatever a kernel reads again or pads:
valid rows only (S = 1500 encoder frames, not the 1536 of the cache's
layout tile), every input byte read once and every output byte written
once, two operations per multiply-add. A kernel's bound is the larger of
its operations over the peak rate and its bytes over the memory rate
(`peaks.json`, NVIDIA's H100 SXM data sheet); its roofline share is that
bound over the device time the trace gives it.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
BF16 = PEAKS["bf16_flops_per_s"]
HBM = PEAKS["hbm_bytes_per_s"]


def bound_s(ops: float, nbytes: float, peak: float = BF16) -> tuple[float, str]:
    """The least time the chip could take, and what bounds it."""
    t_ops, t_bytes = ops / peak, nbytes / HBM
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# --- kernels, per call ------------------------------------------------------

def k1(B: int, H: int, S: int, hd: int) -> tuple[float, float]:
    """K1, encoder self-attention (head-minor, non-causal) of one layer:
    QK^T and PV over S x S per head; q, k, v in and the output out, bf16."""
    return 4.0 * B * H * S * S * hd, 4.0 * B * S * H * hd * 2


def k2(B: int, S: int, D: int, L: int, H: int) -> tuple[float, float]:
    """K2, the int8 cross-KV cache of all L decoder layers from the encoder
    output: [B*S, D] x [D, 2D] per layer; reads x, W_k, W_v, b_v (bf16),
    writes int8 K and V and an fp32 scale per (layer, row, head, side)."""
    ops = 2.0 * B * S * D * 2 * D * L
    nbytes = B * S * D * 2 + L * (2 * D * D + D) * 2 + L * 2 * B * S * D + L * 2 * B * H * S * 4
    return ops, nbytes


def k3(B: int, S: int, D: int, H: int) -> tuple[float, float]:
    """K3, one decode step's cross-attention of one layer over the int8
    cache: reads int8 K and V, their fp32 scales per (row, head) and the
    bf16 query, writes the bf16 output."""
    return 4.0 * B * S * D, 2.0 * B * S * D + 2.0 * B * H * S * 4 + 2.0 * B * D * 2


def attention_pairs(Tq: int, Tk: int, causal: bool) -> float:
    """Query-key pairs that attention needs: a causal square keeps the
    lower triangle with its diagonal."""
    return Tq * (Tq + 1) / 2 if causal else float(Tq) * Tk


def k6(B: int, H: int, Tq: int, Tk: int, hd: int, causal: bool = False) -> dict:
    """K6 (training attention) per call: forward 4, dQ 6 and dK/dV 8
    operations per (query, key, head dim); bytes of the bf16 operands each
    pass reads and writes (with the forward's fp32 log-sum-exp)."""
    p = attention_pairs(Tq, Tk, causal) * B * H * hd
    q, kv, lse = B * H * Tq * hd * 2, B * H * Tk * hd * 2, B * H * Tq * 4
    return {"fwd": (4.0 * p, 2 * q + 2 * kv + lse),          # q, k, v in; o, lse out
            "dq": (6.0 * p, 3 * q + 2 * kv + lse),           # q, o, do, k, v, lse in; dq out
            "dkv": (8.0 * p, 3 * q + 4 * kv + lse)}          # q, o, do, k, v, lse in; dk, dv out


# --- whole models -----------------------------------------------------------

def encoder_flops(c: dict, B: int, lora_rank: int = 0, lora_hooks: int = 0) -> float:
    """The encoder over B 30 s windows: both convolutions, every layer's
    projections, attention and MLP (with `lora_hooks` rank-r adapters of
    D x D projections per layer)."""
    D, F, M, S = c["d_model"], c["ffn_dim"], c["num_mel_bins"], c["max_source_positions"]
    T = 2 * S
    conv = 2.0 * B * T * M * D * 3 + 2.0 * B * S * D * D * 3
    per_layer = (8.0 * B * S * D * D + 4.0 * B * S * S * D + 4.0 * B * S * D * F
                 + lora_hooks * 4.0 * B * S * D * lora_rank)
    return conv + c["encoder_layers"] * per_layer


def cross_cache_flops(c: dict, B: int) -> float:
    """The cross K and V of every decoder layer from the encoder output."""
    D, S = c["d_model"], c["max_source_positions"]
    return c["decoder_layers"] * 4.0 * B * S * D * D


def decode_flops(c: dict, B: int, prompt_len: int, new_tokens: int,
                 lora_rank: int = 0, lora_hooks: int = 0) -> float:
    """Greedy decoding of `new_tokens` after a prompt of `prompt_len`, one
    position at a time over the caches: positions 0 .. prompt_len +
    new_tokens - 2, each self-attending over the positions up to it and
    cross-attending over S frames; logits only where a token is chosen."""
    D, F, S, V = c["d_model"], c["ffn_dim"], c["max_source_positions"], c["vocab_size"]
    L = c["decoder_layers"]
    steps = prompt_len + new_tokens - 1
    self_keys = steps * (steps + 1) / 2                    # sum over positions of (pos + 1)
    per_token = L * (12.0 * D * D + 4.0 * D * F + lora_hooks * 4.0 * D * lora_rank)
    flops = B * (steps * per_token + L * 4.0 * D * self_keys + steps * L * 4.0 * S * D)
    return flops + B * new_tokens * 2.0 * D * V
