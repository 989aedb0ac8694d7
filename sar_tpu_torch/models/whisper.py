"""Whisper in PyTorch (counterpart of sar_tpu/models/whisper.py): the
encoder, the teacher-forced decoder of training and the KV-cached decode
step.

Parameters are plain nested dicts of tensors with the JAX package's layout:
per-stack layer weights are STACKED on a leading [L, ...] axis, linear
weights are [d_in, d_out] (y = x @ w + b). The one layout change is the
encoder convolutions, stored as F.conv1d takes them ([out, in, 3]);
models/convert.py bridges both ways.

Numerics kept from the reference: LayerNorm in fp32 (population variance,
eps 1e-5), matmuls in the params' dtype, exact GELU, q = (h.Wq + bq) *
hd^-0.5, no bias on the k projections, softmax in fp32, logits in fp32 from
the compute-dtype operands.

Covered: `encode(flash=False|True|"hm"|"fq")`, `decode_train`, `forward`,
`shift_tokens_right` and `cross_entropy_loss` (training: flash=True is the
blockwise attention of ops/flash.py, kernel K6, forward and backward;
`remat` checkpoints each layer, saving the plain matmuls and K6's output as
the JAX package's policy does, `_remat`; inference: "hm" is the head-minor
attention kernel K1, "fq" the fused LN + QKV + attention kernel K8, both
in ops/flash_enc.py); `init_cache` and `decode_step` over the unquantized
classic cache (the default, as in the JAX package) and the int8
head-minor cache of serving. Each takes optional LoRA from an
adapter bank (models/lora.py): one adapter for the whole batch, or one per
utterance (`adapter_idx`, masked-dense routing, `lora_delta`), with the
LoRA dropout of training (`lora_dropout`, masks drawn from a seed folded
per side, layer and hook, so a checkpoint recompute draws the same masks).
The cross_v LoRA term of the int8 cache build rides kernel K4
(ops/kv_init.py). Beam search keeps one cross slab per sample and B*K
self-cache rows (`self_batch`); `decode_step(beam_width=K, ancestry=...)`
folds the K beam queries of a sample into one cross-attention call (kernel
K5 over the int8 cache, plain attention over the classic one) and reads
the never-moved self cache through the ancestry matrix
(`_self_attention_beam`).

The opt-in quantized decode: `decode_step(scores_int8=True)` over the int8
head-minor cache quantizes the cross query and the probabilities too, so
both cross contractions are s8 x s8 with exact integer sums (kernel K7,
`_cross_attention_int8_mxu`), and the self-attention takes the same math
in plain torch (`_attention_int8_mxu`). `init_cache(cross_kv_int4=True,
self_kv_int4=True)` builds the classic nibble-packed int4 cache
(`quantize_kv4`: [.., hd/2] s8 bytes, two int4 lanes each), which
`decode_step` tells apart by its hd/2 axis and reads with `_attention_int4`
(plain torch, as in the JAX package).
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from sar_tpu_torch.models.config import WhisperConfig
from sar_tpu_torch.ops import flash as flash_ops
from sar_tpu_torch.ops.decode_cross import (cross_decode_attention,
                                            cross_decode_attention_exact,
                                            cross_decode_reference,
                                            cross_decode_reference_exact,
                                            int_einsum)
from sar_tpu_torch.ops.flash_enc import (encoder_attention_fused,
                                         encoder_attention_fused_reference,
                                         encoder_attention_hm,
                                         encoder_attention_hm_reference,
                                         fused_qkv_supported)
from sar_tpu_torch.ops.kv_init import (fused_kv_init, fused_kv_init_reference,
                                      quantize_rows)

Params = dict[str, Any]

LN_KEYS = ("attn_ln", "mlp_ln", "self_ln", "cross_ln", "ln")


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    y = torch.matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


class LoraCtx(NamedTuple):
    """LoRA of one call. `sel` [B, A] is the one-hot of the per-row adapter
    index in the compute dtype (None: adapter 0 for every row), made once
    per call of encode / decode_train / init_cache / decode_step rather
    than once per projection; `scale` = alpha / r. `dropout` and `seed`
    are training's LoRA dropout: inverted dropout on the branch input, its
    masks drawn from `seed` folded with each hook's salt (None: no
    dropout); `_layer_ctx` folds the layer in."""
    sel: torch.Tensor | None = None
    scale: float = 1.0
    dropout: float = 0.0
    seed: int | None = None


def lora_ctx(lora: Params | None, adapter_idx, scale: float,
             dtype: torch.dtype, dropout: float = 0.0,
             seed: int | None = None) -> LoraCtx:
    """The LoraCtx of one side's bank ({hook: {"a", "b"}}) for a call."""
    if lora is None or adapter_idx is None:
        return LoraCtx(None, scale, dropout, seed)
    la = next(iter(lora.values()))["a"]                         # [L, A, d, r]
    idx = torch.as_tensor(adapter_idx, device=la.device).long()
    return LoraCtx(F.one_hot(idx, la.shape[1]).to(dtype), scale, dropout, seed)


_M64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from `seed` and `data` (splitmix64 of their mix):
    the counterpart of jax.random.fold_in for the port's integer seeds."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def split_seed(seed: int | None) -> tuple[int | None, int | None]:
    """(encoder seed, decoder seed) of a forward's dropout seed."""
    if seed is None:
        return None, None
    return fold_in(seed, 0), fold_in(seed, 1)


def dropout_keep(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """The inverted-dropout multiplier of x's shape: keep / (1 - rate) with
    P(keep) = 1 - rate, in x's dtype. Drawn from a generator of its own
    seeded with `seed`, so the same seed gives the same mask wherever it is
    drawn (a checkpoint recompute restores only the default generators)."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    u = torch.rand(x.shape, generator=g, device=x.device)
    return (u < 1.0 - rate).to(x.dtype) / (1.0 - rate)


def lora_delta(x: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
               ctx: LoraCtx, salt: int = 0) -> torch.Tensor:
    """`scale * (x @ A) @ B` for x [B, T, d_in]; la [A, d_in, r] and lb
    [A, r, d_out] are one layer's slice of a bank entry.

    With ctx.seed set and ctx.dropout > 0, x is first multiplied by the
    inverted-dropout mask of `fold_in(ctx.seed, salt)`.

    ctx.sel None: adapter 0 for every row. Otherwise MASKED-DENSE, as the
    JAX package: x against all A adapters as one [d_in, A*r] product, the
    rank blocks of the other adapters zeroed by the one-hot mask, then one
    [A*r, d_out] product. Both products round to x's dtype, as the einsums
    do there."""
    if ctx.seed is not None and ctx.dropout > 0.0:
        x = x * dropout_keep(x, fold_in(ctx.seed, salt), ctx.dropout)
    if ctx.sel is None:
        u = torch.matmul(x, la[0].to(x.dtype))
        return ctx.scale * torch.matmul(u, lb[0].to(x.dtype))
    A, d_in, r = la.shape
    B, T = x.shape[0], x.shape[1]
    laf = la.transpose(0, 1).reshape(d_in, A * r).to(x.dtype)
    lbf = lb.reshape(A * r, lb.shape[-1]).to(x.dtype)
    u = torch.matmul(x, laf)                                     # [B, T, A*r]
    u = (u.reshape(B, T, A, r) * ctx.sel[:, None, :, None]).reshape(B, T, A * r)
    return ctx.scale * torch.matmul(u, lbf)


def _proj(x: torch.Tensor, p: Params, lora: Params | None,
          ctx: LoraCtx, salt: int = 0) -> torch.Tensor:
    y = linear(x, p)
    if lora is not None:
        y = y + lora_delta(x, lora["a"], lora["b"], ctx, salt)
    return y


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, num_heads, D // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, T, hd = x.shape
    return x.transpose(1, 2).reshape(B, T, H * hd)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Scaled dot-product attention over [B, H, T, hd]; fp32 scores from the
    compute-dtype operands, fp32 softmax, probabilities cast back for the PV
    product. `q` is expected pre-scaled by head_dim**-0.5."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder position table."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _normal(g: torch.Generator, shape, std=0.02) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device) * std


def _linear_stack(g, L, d_in, d_out, bias=True):
    p = {"w": _normal(g, (L, d_in, d_out))}
    if bias:
        p["b"] = torch.zeros((L, d_out), device=g.device)
    return p


def _ln_stack(L, d, device):
    return {"scale": torch.ones((L, d), device=device),
            "bias": torch.zeros((L, d), device=device)}


def _ln(d, device):
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def init_params(cfg: WhisperConfig, generator: torch.Generator,
                device: torch.device | str | None = None) -> Params:
    """Random-init fp32 parameters with the reference's shapes and scheme
    (N(0, 0.02) weights, zero biases, unit LayerNorm, sinusoidal encoder
    positions), drawn from `generator` on its own device, then moved to
    `device` (default: the generator's)."""
    g = generator
    d, f = cfg.d_model, cfg.ffn_dim
    Le, Ld = cfg.encoder_layers, cfg.decoder_layers
    dev = g.device
    enc_layers = {
        "attn_ln": _ln_stack(Le, d, dev),
        "q": _linear_stack(g, Le, d, d),
        "k": _linear_stack(g, Le, d, d, bias=False),
        "v": _linear_stack(g, Le, d, d),
        "o": _linear_stack(g, Le, d, d),
        "mlp_ln": _ln_stack(Le, d, dev),
        "fc1": _linear_stack(g, Le, d, f),
        "fc2": _linear_stack(g, Le, f, d),
    }
    dec_layers = {
        "self_ln": _ln_stack(Ld, d, dev),
        "self_q": _linear_stack(g, Ld, d, d),
        "self_k": _linear_stack(g, Ld, d, d, bias=False),
        "self_v": _linear_stack(g, Ld, d, d),
        "self_o": _linear_stack(g, Ld, d, d),
        "cross_ln": _ln_stack(Ld, d, dev),
        "cross_q": _linear_stack(g, Ld, d, d),
        "cross_k": _linear_stack(g, Ld, d, d, bias=False),
        "cross_v": _linear_stack(g, Ld, d, d),
        "cross_o": _linear_stack(g, Ld, d, d),
        "mlp_ln": _ln_stack(Ld, d, dev),
        "fc1": _linear_stack(g, Ld, d, f),
        "fc2": _linear_stack(g, Ld, f, d),
    }
    params = {
        "encoder": {
            # F.conv1d layout [out, in, 3] (the JAX package stores HIO).
            "conv1": {"w": _normal(g, (d, cfg.num_mel_bins, 3)),
                      "b": torch.zeros((d,), device=dev)},
            "conv2": {"w": _normal(g, (d, d, 3)),
                      "b": torch.zeros((d,), device=dev)},
            "pos_embed": torch.tensor(sinusoids(cfg.max_source_positions, d),
                                      device=dev),
            "layers": enc_layers,
            "ln": _ln(d, dev),
        },
        "decoder": {
            "token_embed": _normal(g, (cfg.vocab_size, d)),
            "pos_embed": _normal(g, (cfg.max_target_positions, d)),
            "layers": dec_layers,
            "ln": _ln(d, dev),
        },
    }
    return tree_map(lambda x: x.to(device or dev), params)


def tree_map(fn, *trees):
    """`fn` over the leaves of one or more nested dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def param_count(params: Params) -> int:
    """Parameters of a tree, without the port's fp32 logits copy of the
    token embedding (`cast_params`)."""
    return sum(param_count(v) if isinstance(v, dict) else v.numel()
               for k, v in params.items() if k != "token_embed_f32")


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Cast matmul-heavy weights to `dtype`, keep LayerNorm params fp32.

    Below fp32 it also keeps `decoder.token_embed_f32`, an fp32 copy of the
    (cast) token embedding made once here: the logits are fp32 products of
    compute-dtype operands, as in the reference, and a compute-dtype GEMM
    would round them (and tie argmaxes on random weights)."""
    def cast(tree, in_ln=False):
        if isinstance(tree, dict):
            return {k: cast(v, in_ln or k in LN_KEYS) for k, v in tree.items()}
        return tree if in_ln else tree.to(dtype)
    out = cast(params)
    if dtype != torch.float32:
        out["decoder"]["token_embed_f32"] = out["decoder"]["token_embed"].float()
    return out


def _layer(stack: Params, l: int) -> Params:
    """Layer l's slice of a stacked [L, ...] parameter tree (views)."""
    return tree_map(lambda x: x[l], stack)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _mha(q, k, v, mask=None, *, causal=False, flash=False):
    """Attention of [B, H, T, hd] heads: flash=True goes through the
    blockwise K6 (ops/flash.py, forward and backward, the [Tq, Tk]
    probabilities never exist); otherwise exact attention with the explicit
    `mask`."""
    if flash:
        return flash_ops.flash_mha(q, k, v, causal=causal)
    return attention(q, k, v, mask)


def _enc_layer_apply(x, p, num_heads, flash=False, t_valid=None, lora=None,
                     ctx: LoraCtx = LoraCtx(), kernels: bool = True):
    lo = lora or {}
    if flash == "fq" and not any(k in lo for k in ("q", "k", "v")):
        # K8: LN + q/k/v projections + attention in one entry point; LoRA
        # on the out-projection alone still composes (below). encode()
        # turns "fq" into "hm" for a bank on q/k/v.
        fused = (encoder_attention_fused if kernels
                 else encoder_attention_fused_reference)
        a_m = fused(x, p["attn_ln"]["scale"], p["attn_ln"]["bias"],
                    p["q"]["w"], p["q"]["b"], p["k"]["w"], p["v"]["w"],
                    p["v"]["b"], n_heads=num_heads, t_valid=t_valid)
    else:
        a_m = _enc_attention(x, p, num_heads, flash, t_valid, lo, ctx, kernels)
    x = x + _proj(a_m, p["o"], lo.get("o"), ctx, 3)
    h = layer_norm(x, p["mlp_ln"]["scale"], p["mlp_ln"]["bias"])
    h = F.gelu(linear(h, p["fc1"]))
    return x + linear(h, p["fc2"])


def _enc_attention(x, p, num_heads, flash, t_valid, lo, ctx, kernels):
    """The unfused attention half of an encoder layer: LN, the (adapted)
    projections, then K1 ("hm" and "fq"), K6 (True) or exact attention."""
    scaling = (x.shape[-1] // num_heads) ** -0.5
    h = layer_norm(x, p["attn_ln"]["scale"], p["attn_ln"]["bias"])
    q = _proj(h, p["q"], lo.get("q"), ctx, 0) * scaling
    k = _proj(h, p["k"], lo.get("k"), ctx, 1)
    v = _proj(h, p["v"], lo.get("v"), ctx, 2)
    if flash in ("hm", "fq"):
        # Head-minor kernel on the residual layout: no split/merge copies;
        # `x` is padded to the kernel's T and keys >= t_valid are masked.
        hm = encoder_attention_hm if kernels else encoder_attention_hm_reference
        return hm(q, k, v, n_heads=num_heads, t_valid=t_valid)
    a = _mha(split_heads(q, num_heads), split_heads(k, num_heads),
             split_heads(v, num_heads), flash=flash)
    return merge_heads(a)


def _layer_ctx(ctx: LoraCtx, layer: int) -> LoraCtx:
    """Layer `layer`'s LoraCtx: the dropout seed folded with its index."""
    if ctx.seed is None:
        return ctx
    return ctx._replace(seed=fold_in(ctx.seed, layer))


# Ops whose outputs a selective checkpoint saves: the plain matmuls (the
# projections and the FFN, which PyTorch's matmul lowers to mm / addmm)
# and K6's forward. Batched products (bmm: the exact path's scores and
# probabilities) are recomputed, as the JAX package's
# dots_with_no_batch_dims_saveable policy does.
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
              flash_ops.FLASH_OP)


def _save_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(body, remat):
    """A layer body under gradient checkpointing, as the JAX package's
    `_remat`: remat=True saves the plain matmuls and K6's output and
    recomputes the rest in the backward (elementwise ops, and the exact
    path's attention), so with flash the backward never runs an attention
    forward again; remat="full" recomputes everything; False runs `body`.
    Outside autograd (no grad) there is nothing to checkpoint."""
    if not remat:
        return body
    kw = {} if remat == "full" else dict(
        context_fn=partial(create_selective_checkpoint_contexts, _save_policy))

    def run(x, *args):
        if not torch.is_grad_enabled():
            return body(x, *args)
        return checkpoint(body, x, *args, use_reentrant=False, **kw)
    return run


def encoder_front(enc: Params, mel: torch.Tensor) -> torch.Tensor:
    """The two GELU convolutions plus positions: mel [B, M, T_frames] ->
    [B, T_frames/2, d] in the weights' dtype."""
    dtype = enc["conv1"]["w"].dtype
    x = mel.to(dtype)                                            # [B, M, T]
    x = F.conv1d(x, enc["conv1"]["w"], padding=1) + enc["conv1"]["b"][:, None].to(dtype)
    x = F.gelu(x)
    x = F.conv1d(x, enc["conv2"]["w"], stride=2, padding=1) + enc["conv2"]["b"][:, None].to(dtype)
    x = F.gelu(x).transpose(1, 2)                                # [B, T, d]
    return x + enc["pos_embed"][:x.shape[1]].to(dtype)


def encoder_layers(enc: Params, x: torch.Tensor, cfg: WhisperConfig,
                   n_layers: int, *, flash: bool | str = False,
                   lora: Params | None = None,
                   ctx: LoraCtx = LoraCtx(), remat=False,
                   kernels: bool = True) -> torch.Tensor:
    """The first `n_layers` encoder layers over x [B, T, d]. flash=True
    takes K6 (training); with flash="hm" (K1) or "fq" (K8 where the layer's
    LoRA leaves q/k/v alone, else K1) the layers run on T padded to
    `cross_pad_len(T)` (padded rows carry garbage that masked keys keep out
    of real rows) and the pad is sliced off after the last layer.
    `kernels=False` takes K1's and K8's plain versions on any device."""
    if flash not in (False, True, "hm", "fq"):
        raise ValueError(f"encode(flash={flash!r}): want False, True, 'hm' "
                         f"or 'fq'")
    T = x.shape[1]
    pad = cross_pad_len(T) - T if flash in ("hm", "fq") else 0
    if pad:
        x = F.pad(x, (0, 0, 0, pad))

    def body(x, l):
        return _enc_layer_apply(x, _layer(enc["layers"], l), cfg.encoder_heads,
                                flash=flash, t_valid=T,
                                lora=_layer(lora, l) if lora else None,
                                ctx=_layer_ctx(ctx, l), kernels=kernels)
    body = _remat(body, remat)
    for l in range(n_layers):
        x = body(x, l)
    return x[:, :T] if pad else x


def encode(params: Params, mel: torch.Tensor, cfg: WhisperConfig, *,
           lora: Params | None = None, adapter_idx=None,
           lora_scale: float = 1.0, lora_dropout: float = 0.0,
           dropout_seed: int | None = None, remat=False,
           flash: bool | str = False, kernels: bool = True) -> torch.Tensor:
    """Encoder forward. mel: [B, num_mel_bins, T_frames] -> [B, T/2, d].

    flash: False = exact attention ([T, T] probabilities materialised);
    True = the blockwise kernel K6 (ops/flash.py, forward and backward: the
    training path); "hm" = the head-minor attention kernel K1
    (ops/flash_enc.py, inference only); "fq" = the fused LN + q/k/v
    projection + attention kernel K8 (inference only). "hm" and "fq" run on
    T padded to `cross_pad_len(T)` with the pad sliced off after the stack.
    "fq" turns into "hm", as in the JAX package, when the bank adapts q, k
    or v (the fused projections have no adapter path) or when
    `fused_qkv_supported` (the JAX package's route rule) refuses the shape.
    `lora` (a bank) adapts the hooks q/k/v/o it holds, with adapter 0 for
    every row or `adapter_idx` [B] per row; `lora_dropout` with
    `dropout_seed` drops the branch inputs (training). `remat` as `_remat`.
    `kernels=False` takes K1's and K8's plain versions on any device."""
    enc = params["encoder"]
    x = encoder_front(enc, mel)
    enc_lora = lora.get("encoder") if lora else None
    if flash == "fq":
        lora_qkv = enc_lora is not None and any(k in enc_lora for k in ("q", "k", "v"))
        if lora_qkv or not fused_qkv_supported(cross_pad_len(x.shape[1]),
                                               x.shape[-1], cfg.encoder_heads):
            flash = "hm"
    ctx = lora_ctx(enc_lora, adapter_idx, lora_scale, x.dtype, lora_dropout,
                   dropout_seed)
    x = encoder_layers(enc, x, cfg, cfg.encoder_layers, flash=flash,
                       lora=enc_lora, ctx=ctx, remat=remat, kernels=kernels)
    return layer_norm(x, enc["ln"]["scale"], enc["ln"]["bias"])


# ---------------------------------------------------------------------------
# Decoder (teacher-forced)
# ---------------------------------------------------------------------------

def _dec_layer_apply(x, enc_out, p, lora, ctx, num_heads, causal_mask,
                     flash=False):
    scaling = (x.shape[-1] // num_heads) ** -0.5
    lo = lora or {}
    H = num_heads
    # Self-attention (causal).
    h = layer_norm(x, p["self_ln"]["scale"], p["self_ln"]["bias"])
    q = _proj(h, p["self_q"], lo.get("self_q"), ctx, 0) * scaling
    k = _proj(h, p["self_k"], lo.get("self_k"), ctx, 1)
    v = _proj(h, p["self_v"], lo.get("self_v"), ctx, 2)
    a = _mha(split_heads(q, H), split_heads(k, H), split_heads(v, H),
             causal_mask, causal=True, flash=flash)
    x = x + _proj(merge_heads(a), p["self_o"], lo.get("self_o"), ctx, 3)
    # Cross-attention.
    h = layer_norm(x, p["cross_ln"]["scale"], p["cross_ln"]["bias"])
    q = _proj(h, p["cross_q"], lo.get("cross_q"), ctx, 4) * scaling
    k = _proj(enc_out, p["cross_k"], lo.get("cross_k"), ctx, 5)
    v = _proj(enc_out, p["cross_v"], lo.get("cross_v"), ctx, 6)
    a = _mha(split_heads(q, H), split_heads(k, H), split_heads(v, H),
             flash=flash)
    x = x + _proj(merge_heads(a), p["cross_o"], lo.get("cross_o"), ctx, 7)
    # MLP.
    h = layer_norm(x, p["mlp_ln"]["scale"], p["mlp_ln"]["bias"])
    h = F.gelu(linear(h, p["fc1"]))
    return x + linear(h, p["fc2"])


def decode_train(params: Params, enc_out: torch.Tensor, tokens: torch.Tensor,
                 cfg: WhisperConfig, *, lora: Params | None = None,
                 adapter_idx=None, lora_scale: float = 1.0,
                 lora_dropout: float = 0.0, dropout_seed: int | None = None,
                 remat=False, flash: bool = False) -> torch.Tensor:
    """Teacher-forced decoder forward. tokens: [B, T] -> logits [B, T, V]
    fp32 (products of the compute-dtype operands summed in fp32). flash=True
    runs the causal self-attention (T x T) and the cross-attention
    (T x S) through K6."""
    dec = params["decoder"]
    dtype = enc_out.dtype
    T = tokens.shape[1]
    x = dec["token_embed"][tokens].to(dtype) + dec["pos_embed"][:T].to(dtype)
    causal = (None if flash else
              torch.ones((T, T), dtype=torch.bool, device=x.device).tril()[None, None])
    dec_lora = lora.get("decoder") if lora else None
    ctx = lora_ctx(dec_lora, adapter_idx, lora_scale, dtype, lora_dropout,
                   dropout_seed)

    def body(x, l):
        return _dec_layer_apply(x, enc_out, _layer(dec["layers"], l),
                                _layer(dec_lora, l) if dec_lora else None,
                                _layer_ctx(ctx, l), cfg.decoder_heads, causal,
                                flash=flash)
    body = _remat(body, remat)
    for l in range(cfg.decoder_layers):
        x = body(x, l)
    x = layer_norm(x, dec["ln"]["scale"], dec["ln"]["bias"])
    return torch.matmul(x.float(), logits_weight(dec).T)


def forward(params: Params, mel: torch.Tensor, tokens: torch.Tensor,
            cfg: WhisperConfig, *, dropout_seed: int | None = None,
            **kw) -> torch.Tensor:
    """Full teacher-forced forward: mel + decoder input tokens -> logits.
    The dropout seed splits into one for each side, as the JAX package
    splits its key."""
    enc_seed, dec_seed = split_seed(dropout_seed)
    enc_out = encode(params, mel, cfg, dropout_seed=enc_seed, **kw)
    return decode_train(params, enc_out, tokens, cfg, dropout_seed=dec_seed,
                        **kw)


def shift_tokens_right(labels: torch.Tensor, start_token_id: int,
                       pad_token_id: int) -> torch.Tensor:
    """Decoder inputs from labels: prepend SOT, drop the last, -100 -> pad."""
    inp = torch.cat([torch.full_like(labels[:, :1], start_token_id),
                     labels[:, :-1]], dim=1)
    return torch.where(inp == -100, torch.full_like(inp, pad_token_id), inp)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over the positions whose label is not -100."""
    mask = labels != -100
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1)


# ---------------------------------------------------------------------------
# KV-cached decoding
# ---------------------------------------------------------------------------

def cross_pad_len(s: int) -> int:
    """Cross-cache S rounded up to the 128-row layout tile."""
    return -(-s // 128) * 128


class DecodeCache(NamedTuple):
    """KV cache for autoregressive decode, in one of three variants of the
    reference's DecodeCache.

    Int8 head-minor (serving): cross K/V are HEAD-MINOR [L, B, S_pad, H*hd]
    int8 with head-major per-(row, head) scales [L, B, H, S_pad]; padded
    rows carry scale 0. The self cache is classic [L, B, H, max_len, hd]
    int8 with scales [L, B, H, max_len].

    Int4 classic (the `kv_int4` opt-in): cross K/V [L, B, H, S, hd/2] and
    self K/V [L, B, H, max_len, hd/2], nibble-packed s8 (`quantize_kv4`),
    with scales [L, B, H, S] and [L, B, H, max_len].

    Unquantized classic (the trainer's evaluation): cross K/V
    [L, B, H, S, hd] and self K/V [L, B, H, max_len, hd] in the compute
    dtype; every scale is None.

    decode_step writes the self cache's column `pos` IN PLACE.
    """
    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_k_scale: torch.Tensor
    cross_v_scale: torch.Tensor
    self_k_scale: torch.Tensor
    self_v_scale: torch.Tensor


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: x [.., S, hd] -> (int8 values, [.., S] scales)."""
    x32 = x.float()
    scale = x32.abs().amax(-1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_kv4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int4, nibble-packed: x [.., S, hd] -> ([.., S, hd/2]
    s8 bytes carrying two int4 lanes, [.., S] scales). Packing is by
    contiguous HALVES of the row, not interleaved pairs: the low nibble of
    byte j holds lane j, the high nibble lane hd/2 + j (two's complement).
    The bytes are assembled in int32, where every value fits, and equal the
    JAX package's int8 shifts bit for bit."""
    hd = x.shape[-1]
    if hd % 2:
        raise ValueError("int4 packing needs an even head_dim")
    x32 = x.float()
    scale = x32.abs().amax(-1).clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -7, 7).int()
    packed = (q[..., hd // 2:] << 4) | (q[..., :hd // 2] & 15)   # in [-112, 127]
    return packed.to(torch.int8), scale


def unpack_kv4(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of quantize_kv4's packing: [.., hd/2] bytes -> (low-half
    lanes, high-half lanes), both s8 in [-8, 7]: the low nibble
    sign-extended, the high nibble by an arithmetic shift."""
    p32 = p.int()
    lo = ((p32 & 15) ^ 8) - 8
    return lo.to(torch.int8), (p32 >> 4).to(torch.int8)


def use_head_minor(*, cross_kv_int8: bool, self_kv_int8: bool,
                   cross_kv_int4: bool = False,
                   self_kv_int4: bool = False) -> bool:
    """The cross-KV layout of a decode path: head-minor slabs (the layout
    K3, K5 and K7 stream) for a full int8 KV cache, the classic layout
    for int4 packing or an unquantized cache. The JAX package also keeps
    a classic int8 layout (for a CPU run without scores_int8, and meshes);
    the port's int8 cache is head-minor on every device."""
    return (cross_kv_int8 and self_kv_int8
            and not (cross_kv_int4 or self_kv_int4))


def init_cache(params: Params, enc_out: torch.Tensor, cfg: WhisperConfig,
               max_len: int, *, lora: Params | None = None,
               adapter_idx=None, lora_scale: float = 1.0,
               cross_kv_int8: bool = False,
               self_kv_int8: bool = False, head_minor: bool | None = None,
               self_batch: int | None = None,
               kernels: bool = True, cross_kv_int4: bool = False,
               self_kv_int4: bool = False) -> DecodeCache:
    """The decode cache of `enc_out`: cross K/V projected once per batch
    and a zeroed self cache of `max_len` positions. By default, as in the
    JAX package, the unquantized classic cache (`_init_cache_classic`, plain
    torch, cross K/V [L, B, H, S, hd] in the compute dtype). With
    cross_kv_int8 = self_kv_int8 = True, the int8 head-minor cache of
    serving: cross K/V projected and quantized by kernel K2
    (fused_kv_init) into head-minor slabs, an int8 self cache. With
    cross_kv_int4 = self_kv_int4 = True (which supersede the int8 flags),
    the classic nibble-packed int4 cache.

    `self_batch` (default B) sizes the self cache apart from the cross
    slabs: beam search keeps ONE cross slab per sample, shared by its K
    beams, and B*K self-cache rows; `adapter_idx` stays per sample.

    A bank that adapts cross_v rides K4: its cross_v slices are gathered
    here once per batch (`a[:, adapter_idx]`, or `a[:, :1]` for one adapter
    shared by the batch) and handed to fused_kv_init. A bank that adapts
    cross_k takes the plain torch projections (`_proj`) plus
    `quantize_rows`, as the JAX package takes its jnp body there.

    `kernels=False` runs the plain PyTorch version on any device (the
    reference path the card's results are compared with).

    `head_minor` defaults to `use_head_minor`'s choice; the port has no
    classic int8 cache, so the int8 flags with head_minor=False raise, as
    does one int8 flag without the other."""
    int4 = cross_kv_int4 or self_kv_int4
    if head_minor is None:
        head_minor = use_head_minor(cross_kv_int8=cross_kv_int8,
                                    self_kv_int8=self_kv_int8,
                                    cross_kv_int4=cross_kv_int4,
                                    self_kv_int4=self_kv_int4)
    if head_minor and int4:
        raise ValueError("head_minor (the s8-kernel layout) does not support "
                         "int4 packing")
    if int4 and not (cross_kv_int4 and self_kv_int4):
        raise NotImplementedError("the port's int4 cache packs the cross and "
                                  "the self K/V both")
    if int4 or not (cross_kv_int8 or self_kv_int8 or head_minor):
        return _init_cache_classic(params, enc_out, cfg, max_len, lora=lora,
                                   adapter_idx=adapter_idx,
                                   lora_scale=lora_scale,
                                   self_batch=self_batch, int4=int4)
    if not (cross_kv_int8 and self_kv_int8 and head_minor):
        raise NotImplementedError(
            "the port's decode cache is the int8 head-minor variant, the "
            "int4 classic one or the unquantized classic one")
    dec = params["decoder"]
    B, S, _ = enc_out.shape
    H, hd = cfg.decoder_heads, cfg.d_model // cfg.decoder_heads
    pad = cross_pad_len(S) - S
    enc_pad = F.pad(enc_out, (0, 0, 0, pad)) if pad else enc_out.contiguous()
    lay = dec["layers"]
    dec_lora = lora.get("decoder") if lora else None
    if dec_lora is not None and "cross_k" in dec_lora:
        ck, cks, cv, cvs = _cross_kv_torch(enc_pad, lay, dec_lora, H, S,
                                           lora_ctx(dec_lora, adapter_idx,
                                                    lora_scale, enc_pad.dtype))
    else:
        kw = {}
        if dec_lora is not None and "cross_v" in dec_lora:
            a, b = dec_lora["cross_v"]["a"], dec_lora["cross_v"]["b"]
            if adapter_idx is None:
                va, vb = a[:, :1], b[:, :1]               # one shared adapter
            else:
                idx = torch.as_tensor(adapter_idx, device=a.device).long()
                va, vb = a[:, idx], b[:, idx]             # [L, B, d, r]
            kw = dict(va=va.to(enc_pad.dtype).contiguous(),
                      vb=vb.to(enc_pad.dtype).contiguous(),
                      lora_scale=lora_scale)
        fn = fused_kv_init if kernels else fused_kv_init_reference
        ck, cks, cv, cvs = fn(enc_pad, lay["cross_k"]["w"], lay["cross_v"]["w"],
                              lay["cross_v"]["b"], n_heads=H, t_valid=S, **kw)
    L = ck.shape[0]
    SB = B if self_batch is None else self_batch
    dev = enc_out.device
    return DecodeCache(
        self_k=torch.zeros((L, SB, H, max_len, hd), dtype=torch.int8, device=dev),
        self_v=torch.zeros((L, SB, H, max_len, hd), dtype=torch.int8, device=dev),
        cross_k=ck, cross_v=cv, cross_k_scale=cks, cross_v_scale=cvs,
        self_k_scale=torch.zeros((L, SB, H, max_len), device=dev),
        self_v_scale=torch.zeros((L, SB, H, max_len), device=dev))


def _init_cache_classic(params: Params, enc_out: torch.Tensor,
                        cfg: WhisperConfig, max_len: int, *,
                        lora: Params | None = None, adapter_idx=None,
                        lora_scale: float = 1.0,
                        self_batch: int | None = None,
                        int4: bool = False) -> DecodeCache:
    """A classic-layout cache (plain torch, as the JAX package's jnp body):
    each layer's (adapted) projection of `enc_out` split into heads, cross
    K/V [L, B, H, S, hd] in the compute dtype and a zeroed self cache
    [L, self_batch, H, max_len, hd] with no scales; or, with `int4`, both
    nibble-packed by `quantize_kv4` ([.., hd/2] s8, fp32 scales)."""
    lay = params["decoder"]["layers"]
    B = enc_out.shape[0]
    H, hd = cfg.decoder_heads, cfg.d_model // cfg.decoder_heads
    dec_lora = lora.get("decoder") if lora else None
    ctx = lora_ctx(dec_lora, adapter_idx, lora_scale, enc_out.dtype)
    L = lay["cross_k"]["w"].shape[0]
    ks, vs = [], []
    for l in range(L):
        p, lo = _layer(lay, l), (_layer(dec_lora, l) if dec_lora else {})
        ks.append(split_heads(_proj(enc_out, p["cross_k"], lo.get("cross_k"), ctx, 5), H))
        vs.append(split_heads(_proj(enc_out, p["cross_v"], lo.get("cross_v"), ctx, 6), H))
    ck, cv = torch.stack(ks), torch.stack(vs)
    cks = cvs = None
    if int4:
        (ck, cks), (cv, cvs) = quantize_kv4(ck), quantize_kv4(cv)
    SB = B if self_batch is None else self_batch
    dev = enc_out.device
    shape = (L, SB, H, max_len, hd // 2 if int4 else hd)
    dtype = torch.int8 if int4 else enc_out.dtype
    return DecodeCache(
        self_k=torch.zeros(shape, dtype=dtype, device=dev),
        self_v=torch.zeros(shape, dtype=dtype, device=dev),
        cross_k=ck, cross_v=cv, cross_k_scale=cks, cross_v_scale=cvs,
        self_k_scale=torch.zeros(shape[:4], device=dev) if int4 else None,
        self_v_scale=torch.zeros(shape[:4], device=dev) if int4 else None)


def _cross_kv_torch(enc_pad, lay, dec_lora, n_heads, t_valid, ctx):
    """Cross K/V of every layer through `_proj` (LoRA on cross_k and/or
    cross_v) and `quantize_rows`: the cache build of banks that adapt
    cross_k, which K4 does not take."""
    L = lay["cross_k"]["w"].shape[0]
    B, S, D = enc_pad.shape
    kq = torch.empty((L, B, S, D), dtype=torch.int8, device=enc_pad.device)
    vq = torch.empty_like(kq)
    ks = torch.empty((L, B, n_heads, S), device=enc_pad.device)
    vs = torch.empty_like(ks)
    for l in range(L):
        p, lo = _layer(lay, l), _layer(dec_lora, l)
        kq[l], ks[l] = quantize_rows(_proj(enc_pad, p["cross_k"], lo.get("cross_k"), ctx),
                                     n_heads, t_valid)
        vq[l], vs[l] = quantize_rows(_proj(enc_pad, p["cross_v"], lo.get("cross_v"), ctx),
                                     n_heads, t_valid)
    return kq, ks, vq, vs


def _attention_int8(q, kq, ks, vq, vs, mask=None):
    """q [B,H,1,hd]; kq/vq [B,H,S,hd] int8; ks/vs [B,H,S] fp32 -> [B,H,1,hd].

    scores_s = ks_s * (q . kq_s); out = sum_s (probs_s * vs_s) vq_s — the
    per-row scales factor out of both products. Plain torch: the reference
    has no production kernel for the self path either."""
    dtype = q.dtype
    scores = torch.matmul(q.float(), kq.float().transpose(-1, -2))
    scores = scores * ks[:, :, None, :]
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    pw = (probs * vs[:, :, None, :]).to(dtype)
    return torch.matmul(pw.float(), vq.float()).to(dtype)


def _attention_int8_mxu(q, kq, ks, vq, vs, mask=None):
    """s8 twin of _attention_int8 (the self-attention of `scores_int8`):
    the query row and the probabilities are also quantized per row to s8,
    so both products are s8 x s8 with exact integer sums (`int_einsum`),
    scaled after the product. Plain torch, as in the JAX package."""
    qq, qs = quantize_kv(q)                                       # [B,H,1,hd], [B,H,1]
    scores = int_einsum("bhqd,bhsd->bhqs", qq, kq) * qs[..., None] * ks[:, :, None, :]
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    pq, ps = quantize_kv(probs * vs[:, :, None, :])               # [B,H,1,S], [B,H,1]
    return (int_einsum("bhqs,bhsd->bhqd", pq, vq) * ps[..., None]).to(q.dtype)


def _attention_int4(q, kp, ks, vp, vs, mask=None):
    """int4 twin of _attention_int8: kp/vp nibble-PACKED [B,H,S,hd/2]
    (quantize_kv4), ks/vs [B,H,S] fp32; q [B,H,Q,hd] -> [B,H,Q,hd]. Each
    product splits into two half-width products over the unpacked nibble
    planes: scores = q_lo . k_lo + q_hi . k_hi, out = concat(p . v_lo,
    p . v_hi); the scales multiply outside, as in the int8 path."""
    dtype = q.dtype
    hd2 = kp.shape[-1]
    kl, kh = unpack_kv4(kp)
    scores = (torch.matmul(q[..., :hd2].float(), kl.float().transpose(-1, -2))
              + torch.matmul(q[..., hd2:].float(), kh.float().transpose(-1, -2)))
    scores = scores * ks[:, :, None, :]
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    pw = (probs * vs[:, :, None, :]).to(dtype).float()
    vl, vh = unpack_kv4(vp)
    return torch.cat([torch.matmul(pw, vl.float()), torch.matmul(pw, vh.float())],
                     dim=-1).to(dtype)


def _cross_attention_int8_mxu(q, kq, ks, vq, vs, *, layer: int, n_heads: int,
                              beam_width: int = 1,
                              kernels: bool = True) -> torch.Tensor:
    """The cross-attention of `scores_int8` over layer `layer` of the
    head-minor slabs (kq/vq [L, B/K, S_pad, D], ks/vs [L, B/K, H, S_pad]):
    the pre-scaled query q [B, 1, D] is quantized per (row, head), the K
    beams of a sample folded into one call (qq [B/K, K, D], qs
    [B/K, K*H, 1], row k*H + h), then kernel K7 or, with kernels=False, its
    plain version. Returns [B, 1, D] in q's dtype. The counterpart of the
    JAX package's jnp twin and of its fused s8 kernel's call."""
    B, _, D = q.shape
    K, H = beam_width, n_heads
    qq, qs = quantize_kv(q.reshape(B // K, K, H, D // H))
    fn = cross_decode_attention if kernels else cross_decode_reference
    o = fn(qq.reshape(B // K, K, D) if K > 1 else qq.reshape(B, D),
           qs.reshape(B // K, K * H, 1), kq, ks, vq, vs, layer=layer,
           n_heads=H, out_dtype=q.dtype)
    return o.reshape(B, 1, D)


def _self_attention_beam(qh, sk, sv, sks, svs, anc, pos: int,
                         beam_width: int) -> torch.Tensor:
    """Reorder-free beam self-attention over a slot-major self cache.

    Slot j's row t was written by the logical beam that held slot j at step
    t and is never moved; anc [Bs, K, T] names the slot that wrote history
    row t of CURRENT beam k. Scores are taken against all K slots, the
    entries that are not (anc-selected and t <= pos) are masked, and the
    softmax runs over the joint (slot, t) axis: one slot is live per t, so
    it equals the per-beam softmax on the selected entries. Rounding points
    as in the JAX package: fp32 scores from the compute-dtype q and K,
    probabilities (times `svs` when given) cast to the compute dtype, fp32
    PV.

    qh [Bs*K, H, 1, hd] beam-major rows; sk/sv [Bs*K, H, T, hd], int8 with
    sks/svs [Bs*K, H, T] fp32, or in the compute dtype with sks = svs =
    None (the unquantized cache) -> [Bs*K, H, 1, hd]."""
    BK, H, T, hd = sk.shape
    K = beam_width
    Bs = BK // K
    dtype = qh.dtype
    q = qh[:, :, 0].reshape(Bs, K, H, hd).float()
    scores = torch.einsum("bkhd,bjhtd->bhkjt", q,
                          sk.reshape(Bs, K, H, T, hd).float())
    if sks is not None:
        scores = scores * sks.reshape(Bs, K, H, T).transpose(1, 2)[:, :, None]
    slots = torch.arange(K, device=anc.device)
    live = anc[:, None, :, None, :T] == slots[None, None, None, :, None]
    live = live & (torch.arange(T, device=anc.device) <= pos)
    scores = torch.where(live, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores.reshape(Bs, H, K, K * T), dim=-1)
    probs = probs.reshape(Bs, H, K, K, T)
    if svs is not None:
        probs = probs * svs.reshape(Bs, K, H, T).transpose(1, 2)[:, :, None]
    pw = probs.to(dtype)
    out = torch.einsum("bhkjt,bjhtd->bkhd", pw.float(),
                       sv.reshape(Bs, K, H, T, hd).float()).to(dtype)
    return out.reshape(BK, H, 1, hd)


def logits_weight(dec: Params) -> torch.Tensor:
    """fp32 token embedding for the logits (see cast_params)."""
    emb = dec["token_embed"]
    return emb if emb.dtype == torch.float32 else dec["token_embed_f32"]


def decode_step(params: Params, tokens: torch.Tensor, pos: int,
                cache: DecodeCache, cfg: WhisperConfig, *,
                lora: Params | None = None, adapter_idx=None,
                lora_scale: float = 1.0, scores_int8: bool = False,
                beam_width: int = 1, ancestry: torch.Tensor | None = None,
                kernels: bool = True) -> tuple[torch.Tensor, DecodeCache]:
    """One autoregressive step. tokens: [B] int64 at position `pos` (< the
    self cache's max_len). Returns (logits [B, V] fp32, cache), the self
    cache updated in place at column `pos`.

    The cross path over the int8 head-minor cache goes through a decode
    kernel (ops/decode_cross.py): K3/K5, or K7 with `scores_int8`, which
    also takes the self-attention to s8 (`_attention_int8_mxu`);
    `kernels=False` runs the kernels' plain versions on any device. An int4
    cache (told apart by its hd/2 axis) is read by `_attention_int4`, the
    unquantized classic cache (no scales) by plain `attention`, as in the
    JAX package.
    `lora` adapts the decoder hooks it holds (self_q/k/v/o, cross_q/o;
    cross_k/v live in the cache), per row when `adapter_idx` is given.

    `beam_width` K > 1: rows are beam-major groups of K per sample (row
    b*K+k = sample b, beam k) over a cache whose cross slabs hold ONE copy
    per sample; the K queries of a sample are folded into one cross call
    (q [B/K, K, D], kernel K5 or K7; [B/K, H, K, hd] query rows of plain
    attention over the classic cache), so each slab is read once for its
    beams. `ancestry` [B/K, K, max_len] (beam mode only, not with int4 or
    scores_int8, whose beams reorder the self cache) reads the self cache as
    slot-major (`_self_attention_beam`); its column `pos` must be the
    identity, since each beam writes its own slot at this step."""
    H = cfg.decoder_heads
    half = cfg.d_model // H // 2
    plain_cache = cache.self_k_scale is None
    self_int4 = not plain_cache and cache.self_k.shape[-1] == half
    cross_int4 = (cache.cross_k_scale is not None and cache.cross_k.dim() == 5
                  and cache.cross_k.shape[-1] == half)
    if not plain_cache and not cross_int4 and cache.cross_k.dim() != 4:
        raise NotImplementedError("decode_step takes the int8 head-minor "
                                  "cache, the int4 classic one or the "
                                  "unquantized classic one")
    if scores_int8 and (plain_cache or cache.cross_k_scale is None):
        raise ValueError("scores_int8 requires an int8 KV cache "
                         "(cross_kv_int8=True and self_kv_int8=True)")
    if scores_int8 and (self_int4 or cross_int4):
        raise ValueError("scores_int8 (the s8-MXU path) does not compose "
                         "with int4-packed KV")
    if ancestry is not None and (beam_width <= 1 or self_int4 or scores_int8):
        raise ValueError("ancestry (reorder-free beam self-attention) needs "
                         "beam_width > 1 and does not compose with int4 "
                         "self-KV or scores_int8")
    B = tokens.shape[0]
    if cache.cross_k.shape[1] * beam_width != B:
        raise ValueError(f"{B} rows do not fold into beams of {beam_width} "
                         f"over {cache.cross_k.shape[1]} cross slabs")
    dec = params["decoder"]
    dtype = dec["token_embed"].dtype
    max_len = cache.self_k.shape[3]
    x = dec["token_embed"][tokens][:, None, :].to(dtype)         # [B, 1, d]
    x = x + dec["pos_embed"][pos].to(dtype)
    pos_mask = (torch.arange(max_len, device=x.device) <= pos)[None, None, None, :]
    scaling = (cfg.d_model // H) ** -0.5
    cross = cross_decode_attention_exact if kernels else cross_decode_reference_exact
    self_attn = (_attention_int4 if self_int4 else
                 _attention_int8_mxu if scores_int8 else _attention_int8)
    quant = quantize_kv4 if self_int4 else quantize_kv
    dec_lora = lora.get("decoder") if lora else None
    ctx = lora_ctx(dec_lora, adapter_idx, lora_scale, dtype)

    for l in range(cache.self_k.shape[0]):
        p = _layer(dec["layers"], l)
        lo = _layer(dec_lora, l) if dec_lora else {}
        # Self-attention against the cache (row `pos` written first).
        h = layer_norm(x, p["self_ln"]["scale"], p["self_ln"]["bias"])
        q = _proj(h, p["self_q"], lo.get("self_q"), ctx) * scaling
        k = split_heads(_proj(h, p["self_k"], lo.get("self_k"), ctx), H)
        v = split_heads(_proj(h, p["self_v"], lo.get("self_v"), ctx), H)
        if plain_cache:
            cache.self_k[l, :, :, pos] = k[:, :, 0]
            cache.self_v[l, :, :, pos] = v[:, :, 0]
            if ancestry is not None:
                a = _self_attention_beam(split_heads(q, H), cache.self_k[l],
                                         cache.self_v[l], None, None, ancestry,
                                         pos, beam_width)
            else:
                a = attention(split_heads(q, H), cache.self_k[l],
                              cache.self_v[l], mask=pos_mask)
        else:
            kq, ks = quant(k)
            vq, vs = quant(v)
            cache.self_k[l, :, :, pos] = kq[:, :, 0]
            cache.self_v[l, :, :, pos] = vq[:, :, 0]
            cache.self_k_scale[l, :, :, pos] = ks[:, :, 0]
            cache.self_v_scale[l, :, :, pos] = vs[:, :, 0]
            if ancestry is not None:
                a = _self_attention_beam(split_heads(q, H), cache.self_k[l],
                                         cache.self_v[l], cache.self_k_scale[l],
                                         cache.self_v_scale[l], ancestry, pos,
                                         beam_width)
            else:
                a = self_attn(split_heads(q, H), cache.self_k[l],
                              cache.self_k_scale[l], cache.self_v[l],
                              cache.self_v_scale[l], mask=pos_mask)
        x = x + _proj(merge_heads(a), p["self_o"], lo.get("self_o"), ctx)
        # Cross-attention: exact over the classic cache, int4 over the
        # packed classic slabs, or over the head-minor int8 slabs of layer
        # l (K3/K5 exact, K7 with scores_int8); beam queries are folded per
        # sample ([B/K, K, ...]) when beam_width > 1.
        h = layer_norm(x, p["cross_ln"]["scale"], p["cross_ln"]["bias"])
        q = _proj(h, p["cross_q"], lo.get("cross_q"), ctx) * scaling
        if plain_cache:
            # The K beam queries of a sample ride its one cross slab as K
            # query rows ([B/K, H, K, hd]), unfolded after.
            qh = q.reshape(B // beam_width, beam_width, H, -1).transpose(1, 2)
            a = attention(qh, cache.cross_k[l], cache.cross_v[l])
            o = a.transpose(1, 2).reshape(B, 1, -1)
        elif cross_int4:
            qh = q.reshape(B // beam_width, beam_width, H, -1).transpose(1, 2)
            a = _attention_int4(qh, cache.cross_k[l], cache.cross_k_scale[l],
                                cache.cross_v[l], cache.cross_v_scale[l])
            o = a.transpose(1, 2).reshape(B, 1, -1)
        elif scores_int8:
            o = _cross_attention_int8_mxu(q, cache.cross_k, cache.cross_k_scale,
                                          cache.cross_v, cache.cross_v_scale,
                                          layer=l, n_heads=H,
                                          beam_width=beam_width, kernels=kernels)
        else:
            qc = (q[:, 0].reshape(B // beam_width, beam_width, -1)
                  if beam_width > 1 else q[:, 0])
            o = cross(qc, cache.cross_k, cache.cross_k_scale, cache.cross_v,
                      cache.cross_v_scale, layer=l, n_heads=H)
        x = x + _proj(o.reshape(B, 1, -1), p["cross_o"], lo.get("cross_o"), ctx)
        # MLP.
        h = layer_norm(x, p["mlp_ln"]["scale"], p["mlp_ln"]["bias"])
        h = F.gelu(linear(h, p["fc1"]))
        x = x + linear(h, p["fc2"])
    x = layer_norm(x, dec["ln"]["scale"], dec["ln"]["bias"])
    logits = torch.matmul(x[:, 0].float(), logits_weight(dec).T)
    return logits, cache
