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
the compute-dtype operands. An OWSM config (`encoder_kind`
"ebranchformer") runs models/ebranchformer.py's encoder and this decoder
with the config's FFN activation (ReLU), LayerNorm eps (1e-12) and untied
logits (an output layer with a bias, `decoder.out`).

Covered: `encode(flash=False|True|"hm"|"fq")`, `decode_train`, `forward`,
`shift_tokens_right` and `cross_entropy_loss` (training: flash=True is the
blockwise attention of ops/flash.py, kernel K6, forward and backward;
`remat` checkpoints each layer, saving the plain matmuls and K6's output as
the JAX package's policy does, `_remat`; inference: "hm" is the head-minor
attention kernel K1, "fq" the fused LN + QKV + attention kernel K8, both
in ops/flash_enc.py); `init_cache` and `decode_step` over the unquantized
classic cache (the default, as in the JAX package), the int8
head-minor cache of serving and, on request (`head_minor=False`), the JAX
package's classic int8 cache in plain torch. Each takes optional LoRA from an
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

Tensor parallelism: `encode`, `encoder_layers`, `decode_train`, `forward`,
`init_cache`, `decode_step` and `decode_cross_attn` take `tp`, the "model"
group of a mesh (parallel/sharding.py), with `params` this rank's shard:
q/k/v and fc1 hold a share of their output columns (column parallel), o
and fc2 the matching input rows (row parallel: the partial products are
summed over the group, then the bias is added once), the token embedding
a range of the vocabulary (the lookup summed, the logits gathered), the
conv stems a share of their channels (gathered after each). Each rank
attends over its heads, whose count is read from its weights' width. A
LoRA bank stays whole on every rank and is sliced where it meets a split
projection. With `tp=None` no collective runs and every path is the one
above.
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
from sar_tpu_torch.ops import layer_norm as ln_ops
from sar_tpu_torch.ops.decode_cross import (cross_decode_attention,
                                            cross_decode_attention_exact,
                                            cross_decode_reference,
                                            cross_decode_reference_exact,
                                            int_einsum)
from sar_tpu_torch.ops.decode_self_exact import self_decode_attention_exact
from sar_tpu_torch.ops.flash_enc import (encoder_attention_fused,
                                         encoder_attention_fused_reference,
                                         encoder_attention_hm,
                                         encoder_attention_hm_reference,
                                         fused_qkv_supported)
from sar_tpu_torch.ops.kv_init import (fused_kv_init, fused_kv_init_reference,
                                      quantize_rows)
from sar_tpu_torch.ops.layer_norm import layer_norm_reference as layer_norm
from sar_tpu_torch.parallel.sharding import (ModelGroup, model_gather,
                                             model_sum, split_range)

Params = dict[str, Any]

# Groups kept in fp32 by cast_params: the LayerNorms (Whisper's, and the
# E-Branchformer's of models/ebranchformer.py) and the frontend's feature
# statistics (ops/fbank.py).
LN_KEYS = ("attn_ln", "mlp_ln", "self_ln", "cross_ln", "ln", "ff1_ln", "ff2_ln",
           "cgmlp_ln", "cgmlp_gate_ln", "final_ln", "mvn")


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------

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
    rows: tuple[int, int, int] | None = None


def lora_ctx(lora: Params | None, adapter_idx, scale: float,
             dtype: torch.dtype, dropout: float = 0.0,
             seed: int | None = None,
             rows: tuple[int, int, int] | None = None) -> LoraCtx:
    """The LoraCtx of one side's bank ({hook: {"a", "b"}}) for a call.
    `rows` (lo, hi, n): the batch holds rows [lo, hi) of a global batch of
    n (a data-parallel shard), and the dropout masks are the global
    batch's at those rows."""
    if lora is None or adapter_idx is None:
        return LoraCtx(None, scale, dropout, seed, rows)
    la = next(iter(lora.values()))["a"]                         # [L, A, d, r]
    idx = torch.as_tensor(adapter_idx, device=la.device).long()
    return LoraCtx(F.one_hot(idx, la.shape[1]).to(dtype), scale, dropout, seed,
                   rows)


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


def dropout_keep(x: torch.Tensor, seed: int, rate: float,
                 rows: tuple[int, int, int] | None = None,
                 cols: tuple[int, int, int] | None = None) -> torch.Tensor:
    """The inverted-dropout multiplier of x's shape: keep / (1 - rate) with
    P(keep) = 1 - rate, in x's dtype. Drawn from a generator of its own
    seeded with `seed`, so the same seed gives the same mask wherever it is
    drawn (a checkpoint recompute restores only the default generators).
    Where x is a shard of a larger tensor, rows [lo, hi) of n on the first
    axis (`rows`) and/or columns [lo, hi) of n on the last (`cols`), the
    mask is drawn at the whole tensor's shape and cut to x's part, so that
    every layout of a batch over the ranks draws the same masks."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    shape = list(x.shape)
    if rows is not None:
        shape[0] = rows[2]
    if cols is not None:
        shape[-1] = cols[2]
    u = torch.rand(shape, generator=g, device=x.device)
    if rows is not None:
        u = u[rows[0]:rows[1]]
    if cols is not None:
        u = u[..., cols[0]:cols[1]]
    return (u < 1.0 - rate).to(x.dtype) / (1.0 - rate)


def lora_delta(x: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
               ctx: LoraCtx, salt: int = 0,
               cols: tuple[int, int, int] | None = None) -> torch.Tensor:
    """`scale * (x @ A) @ B` for x [B, T, d_in]; la [A, d_in, r] and lb
    [A, r, d_out] are one layer's slice of a bank entry.

    With ctx.seed set and ctx.dropout > 0, x is first multiplied by the
    inverted-dropout mask of `fold_in(ctx.seed, salt)` (`cols`: x holds
    columns [lo, hi) of n of the branch input, as `dropout_keep` takes
    them).

    ctx.sel None: adapter 0 for every row. Otherwise MASKED-DENSE, as the
    JAX package: x against all A adapters as one [d_in, A*r] product, the
    rank blocks of the other adapters zeroed by the one-hot mask, then one
    [A*r, d_out] product. Both products round to x's dtype, as the einsums
    do there."""
    if ctx.seed is not None and ctx.dropout > 0.0:
        shard = {k: v for k, v in (("rows", ctx.rows), ("cols", cols)) if v}
        x = x * dropout_keep(x, fold_in(ctx.seed, salt), ctx.dropout, **shard)
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
          ctx: LoraCtx, salt: int = 0, tp: ModelGroup | None = None) -> torch.Tensor:
    """An (adapted) projection; under tensor parallelism (`tp`) a column-
    parallel one: `p` holds this rank's output columns, and so does the
    LoRA term (B's columns of the replicated bank)."""
    y = linear(x, p)
    if lora is not None:
        lb = lora["b"]
        if tp is not None:
            lo, hi = split_range(lb.shape[-1], tp)
            lb = lb[..., lo:hi]
        y = y + lora_delta(x, lora["a"], lb, ctx, salt)
    return y


def _row_proj(x: torch.Tensor, p: Params, lora: Params | None, ctx: LoraCtx,
              salt: int = 0, tp: ModelGroup | None = None) -> torch.Tensor:
    """A row-parallel projection under `tp`: x holds this rank's input
    columns and `p` the matching rows of w; the partial products (the LoRA
    term's too, from A's rows of the replicated bank) are summed over
    "model", then the bias is added once. Without `tp`, `_proj`."""
    if tp is None:
        return _proj(x, p, lora, ctx, salt)
    y = _row_sum(x, p, lora, ctx, salt, tp)
    return y + p["b"].to(y.dtype) if "b" in p else y


def _row_sum(x: torch.Tensor, p: Params, lora: Params | None, ctx: LoraCtx,
             salt: int, tp: ModelGroup) -> torch.Tensor:
    """`_row_proj` under `tp` before its bias: the partial products and
    LoRA terms summed over "model"."""
    y = torch.matmul(x, p["w"])
    if lora is not None:
        la = lora["a"]
        lo, hi = split_range(la.shape[-2], tp)
        y = y + lora_delta(x, la[..., lo:hi, :], lora["b"], ctx, salt,
                           cols=(lo, hi, la.shape[-2]))
    return model_sum(y, tp)


def _row_proj_parts(x: torch.Tensor, p: Params, lora: Params | None, ctx: LoraCtx,
                    tp: ModelGroup | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """`_row_proj` as (y, b), y + b in y's dtype being `_row_proj`'s output:
    b is the bias where it is the last term added (no LoRA term, or under
    `tp`, whose sum comes before the bias), else None and y the whole
    output (`linear` adds the bias before the LoRA term)."""
    if tp is not None:
        return _row_sum(x, p, lora, ctx, 0, tp), p.get("b")
    if lora is None:
        return torch.matmul(x, p["w"]), p.get("b")
    return _proj(x, p, lora, ctx), None


def _row_linear(x: torch.Tensor, p: Params, tp: ModelGroup | None) -> torch.Tensor:
    """`linear` of a row-parallel layer (fc2) under `tp`."""
    return linear(x, p) if tp is None else _row_proj(x, p, None, LoraCtx(), tp=tp)


def _heads(n_heads: int, width: int, d_model: int) -> int:
    """Heads held by a projection `width` wide: all of `n_heads` at
    d_model, a rank's share under tensor parallelism."""
    return n_heads * width // d_model


def embed_tokens(dec: Params, tokens: torch.Tensor, vocab: int,
                 tp: ModelGroup | None = None) -> torch.Tensor:
    """The token embedding rows of `tokens`; under `tp` each rank holds a
    range of the `vocab` rows, looks up the tokens inside it (zeros for the
    rest) and the ranks' rows are summed."""
    emb = dec["token_embed"]
    if tp is None:
        return emb[tokens]
    lo, hi = split_range(vocab, tp)
    local = tokens - lo
    ok = (local >= 0) & (local < hi - lo)
    rows = emb[local.clamp(0, hi - lo - 1)]
    return model_sum(torch.where(ok[..., None], rows, torch.zeros_like(rows)), tp)


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
    `device` (default: the generator's). Whisper's layout only: an OWSM
    config's weights come in their published form through
    `ebranchformer.port_params`."""
    if cfg.encoder_kind != "whisper":
        raise ValueError(f"init_params makes Whisper's layout, not {cfg.name}'s "
                         f"({cfg.encoder_kind}): see ebranchformer.port_params")
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
    token embedding or of the output layer (`cast_params`)."""
    return sum(param_count(v) if isinstance(v, dict) else v.numel()
               for k, v in params.items() if k not in ("token_embed_f32", "out_f32"))


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Cast matmul-heavy weights to `dtype`, keep LayerNorm params fp32.

    Below fp32 it also keeps `decoder.token_embed_f32`, an fp32 copy of the
    (cast) token embedding made once here (or, for untied logits,
    `decoder.out_f32`, one of the output layer's weight): the logits are
    fp32 products of compute-dtype operands, as in the reference, and a
    compute-dtype GEMM would round them (and tie argmaxes on random
    weights)."""
    def cast(tree, in_ln=False):
        if isinstance(tree, dict):
            return {k: cast(v, in_ln or k in LN_KEYS) for k, v in tree.items()}
        return tree if in_ln else tree.to(dtype)
    out = cast(params)
    if dtype != torch.float32:
        dec = out["decoder"]
        if "out" in dec:
            dec["out_f32"] = dec["out"]["w"].float()
        else:
            dec["token_embed_f32"] = dec["token_embed"].float()
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
                     ctx: LoraCtx = LoraCtx(), kernels: bool = True, tp=None):
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
        a_m = _enc_attention(x, p, num_heads, flash, t_valid, lo, ctx, kernels, tp)
    x = x + _row_proj(a_m, p["o"], lo.get("o"), ctx, 3, tp)
    h = layer_norm(x, p["mlp_ln"]["scale"], p["mlp_ln"]["bias"])
    h = F.gelu(linear(h, p["fc1"]))
    return x + _row_linear(h, p["fc2"], tp)


def _enc_attention(x, p, num_heads, flash, t_valid, lo, ctx, kernels, tp=None,
                   eps: float = 1e-5, norm=layer_norm):
    """The unfused attention half of an encoder layer: LN (`norm`, of
    `eps`), the (adapted) projections, then K1 ("hm" and "fq"), K6 (True)
    or exact attention. `num_heads` are the heads of the projections'
    width (a rank's share under `tp`)."""
    scaling = (p["q"]["w"].shape[-1] // num_heads) ** -0.5
    h = norm(x, p["attn_ln"]["scale"], p["attn_ln"]["bias"], eps)
    q = _proj(h, p["q"], lo.get("q"), ctx, 0, tp) * scaling
    k = _proj(h, p["k"], lo.get("k"), ctx, 1, tp)
    v = _proj(h, p["v"], lo.get("v"), ctx, 2, tp)
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


def encoder_front(enc: Params, mel: torch.Tensor,
                  tp: ModelGroup | None = None) -> torch.Tensor:
    """The two GELU convolutions plus positions: mel [B, M, T_frames] ->
    [B, T_frames/2, d] in the weights' dtype. Under `tp` each rank holds a
    share of each convolution's output channels, gathered over "model"
    after each (the next op takes every channel)."""
    dtype = enc["conv1"]["w"].dtype
    d = enc["pos_embed"].shape[-1]
    x = mel.to(dtype)                                            # [B, M, T]
    x = F.conv1d(x, enc["conv1"]["w"], padding=1) + enc["conv1"]["b"][:, None].to(dtype)
    x = model_gather(F.gelu(x), tp, 1, d)
    x = F.conv1d(x, enc["conv2"]["w"], stride=2, padding=1) + enc["conv2"]["b"][:, None].to(dtype)
    x = model_gather(F.gelu(x), tp, 1, d).transpose(1, 2)       # [B, T, d]
    return x + enc["pos_embed"][:x.shape[1]].to(dtype)


def encoder_layers(enc: Params, x: torch.Tensor, cfg: WhisperConfig,
                   n_layers: int, *, flash: bool | str = False,
                   lora: Params | None = None,
                   ctx: LoraCtx = LoraCtx(), remat=False,
                   kernels: bool = True,
                   tp: ModelGroup | None = None) -> torch.Tensor:
    """The first `n_layers` encoder layers over x [B, T, d]. flash=True
    takes K6 (training); with flash="hm" (K1) or "fq" (K8 where the layer's
    LoRA leaves q/k/v alone, else K1) the layers run on T padded to
    `cross_pad_len(T)` (padded rows carry garbage that masked keys keep out
    of real rows) and the pad is sliced off after the last layer.
    `kernels=False` takes K1's and K8's plain versions on any device.
    `tp` (the "model" group): `enc` holds this rank's shard
    (parallel/sharding.py), each layer attends over the rank's heads and
    sums its row-parallel products over the group."""
    if flash not in (False, True, "hm", "fq"):
        raise ValueError(f"encode(flash={flash!r}): want False, True, 'hm' "
                         f"or 'fq'")
    T = x.shape[1]
    pad = cross_pad_len(T) - T if flash in ("hm", "fq") else 0
    if pad:
        x = F.pad(x, (0, 0, 0, pad))

    heads = _heads(cfg.encoder_heads, enc["layers"]["q"]["w"].shape[-1], cfg.d_model)

    def body(x, l):
        return _enc_layer_apply(x, _layer(enc["layers"], l), heads,
                                flash=flash, t_valid=T,
                                lora=_layer(lora, l) if lora else None,
                                ctx=_layer_ctx(ctx, l), kernels=kernels, tp=tp)
    body = _remat(body, remat)
    for l in range(n_layers):
        x = body(x, l)
    return x[:, :T] if pad else x


def encode(params: Params, mel: torch.Tensor, cfg: WhisperConfig, *,
           lora: Params | None = None, adapter_idx=None,
           lora_scale: float = 1.0, lora_dropout: float = 0.0,
           dropout_seed: int | None = None, remat=False,
           flash: bool | str = False, kernels: bool = True,
           tp: ModelGroup | None = None,
           dropout_rows: tuple[int, int, int] | None = None) -> torch.Tensor:
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
    `kernels=False` takes K1's and K8's plain versions on any device.
    `tp` (the "model" group) runs a tensor-parallel shard of the params
    (`encoder_layers`); "fq" is "hm" there (the fused projections take the
    whole width). `dropout_rows` (lo, hi, n): mel holds rows [lo, hi) of a
    global batch of n, whose dropout masks are drawn (a data-parallel
    shard). A config whose `encoder_kind` is "ebranchformer" (OWSM) runs
    models/ebranchformer.py's encoder with the same arguments."""
    if cfg.encoder_kind == "ebranchformer":
        from sar_tpu_torch.models import ebranchformer
        return ebranchformer.encode(
            params, mel, cfg, lora=lora, adapter_idx=adapter_idx,
            lora_scale=lora_scale, lora_dropout=lora_dropout,
            dropout_seed=dropout_seed, remat=remat, flash=flash,
            kernels=kernels, tp=tp, dropout_rows=dropout_rows)
    enc = params["encoder"]
    x = encoder_front(enc, mel, tp)
    enc_lora = lora.get("encoder") if lora else None
    if flash == "fq" and tp is not None:
        flash = "hm"
    if flash == "fq":
        lora_qkv = enc_lora is not None and any(k in enc_lora for k in ("q", "k", "v"))
        if lora_qkv or not fused_qkv_supported(cross_pad_len(x.shape[1]),
                                               x.shape[-1], cfg.encoder_heads):
            flash = "hm"
    ctx = lora_ctx(enc_lora, adapter_idx, lora_scale, x.dtype, lora_dropout,
                   dropout_seed, dropout_rows)
    x = encoder_layers(enc, x, cfg, cfg.encoder_layers, flash=flash,
                       lora=enc_lora, ctx=ctx, remat=remat, kernels=kernels,
                       tp=tp)
    return layer_norm(x, enc["ln"]["scale"], enc["ln"]["bias"])


def resolve_flash(flash: bool | str, device: torch.device) -> bool | str:
    """`encode`'s `flash` for inference on `device`: "auto" is "hm" (K1) on
    a CUDA device and exact attention elsewhere (K1's plain version is
    slower on the CPU); any other value stays."""
    if flash != "auto":
        return flash
    return "hm" if device.type == "cuda" else False


# ---------------------------------------------------------------------------
# Decoder (teacher-forced)
# ---------------------------------------------------------------------------

def decoder_act(cfg: WhisperConfig):
    """The decoder FFN's activation: Whisper's exact GELU or OWSM's ReLU."""
    return F.relu if cfg.decoder_act == "relu" else F.gelu


def _dec_layer_apply(x, enc_out, p, lora, ctx, num_heads, causal_mask,
                     flash=False, tp=None, act=F.gelu, eps: float = 1e-5):
    scaling = (p["self_q"]["w"].shape[-1] // num_heads) ** -0.5
    lo = lora or {}
    H = num_heads
    # Self-attention (causal).
    h = layer_norm(x, p["self_ln"]["scale"], p["self_ln"]["bias"], eps)
    q = _proj(h, p["self_q"], lo.get("self_q"), ctx, 0, tp) * scaling
    k = _proj(h, p["self_k"], lo.get("self_k"), ctx, 1, tp)
    v = _proj(h, p["self_v"], lo.get("self_v"), ctx, 2, tp)
    a = _mha(split_heads(q, H), split_heads(k, H), split_heads(v, H),
             causal_mask, causal=True, flash=flash)
    x = x + _row_proj(merge_heads(a), p["self_o"], lo.get("self_o"), ctx, 3, tp)
    # Cross-attention.
    h = layer_norm(x, p["cross_ln"]["scale"], p["cross_ln"]["bias"], eps)
    q = _proj(h, p["cross_q"], lo.get("cross_q"), ctx, 4, tp) * scaling
    k = _proj(enc_out, p["cross_k"], lo.get("cross_k"), ctx, 5, tp)
    v = _proj(enc_out, p["cross_v"], lo.get("cross_v"), ctx, 6, tp)
    a = _mha(split_heads(q, H), split_heads(k, H), split_heads(v, H),
             flash=flash)
    x = x + _row_proj(merge_heads(a), p["cross_o"], lo.get("cross_o"), ctx, 7, tp)
    # MLP.
    h = layer_norm(x, p["mlp_ln"]["scale"], p["mlp_ln"]["bias"], eps)
    h = act(linear(h, p["fc1"]))
    return x + _row_linear(h, p["fc2"], tp)


def decoder_heads(params: Params, cfg: WhisperConfig) -> int:
    """The decoder heads `params` hold: all of them, or a rank's share of a
    tensor-parallel shard."""
    return _heads(cfg.decoder_heads,
                  params["decoder"]["layers"]["self_q"]["w"].shape[-1], cfg.d_model)


def _logits(x: torch.Tensor, dec: Params, cfg: WhisperConfig,
            tp: ModelGroup | None) -> torch.Tensor:
    """fp32 logits of the final hidden states x [..., d] (plus the output
    layer's bias where the logits are untied); under `tp` each rank's
    vocabulary range, gathered over "model"."""
    y = torch.matmul(x.float(), logits_weight(dec).T)
    if "out" in dec:
        y = y + dec["out"]["b"].float()
    return model_gather(y, tp, -1, cfg.vocab_size)


def decode_train(params: Params, enc_out: torch.Tensor, tokens: torch.Tensor,
                 cfg: WhisperConfig, *, lora: Params | None = None,
                 adapter_idx=None, lora_scale: float = 1.0,
                 lora_dropout: float = 0.0, dropout_seed: int | None = None,
                 remat=False, flash: bool = False,
                 tp: ModelGroup | None = None,
                 dropout_rows: tuple[int, int, int] | None = None) -> torch.Tensor:
    """Teacher-forced decoder forward. tokens: [B, T] -> logits [B, T, V]
    fp32 (products of the compute-dtype operands summed in fp32). flash=True
    runs the causal self-attention (T x T) and the cross-attention
    (T x S) through K6. `tp` and `dropout_rows` as in `encode`: under
    `tp` the vocabulary is split too, so the token lookup sums over
    "model" and the logits are gathered."""
    dec = params["decoder"]
    dtype = enc_out.dtype
    T = tokens.shape[1]
    x = (embed_tokens(dec, tokens, cfg.vocab_size, tp).to(dtype)
         + dec["pos_embed"][:T].to(dtype))
    causal = (None if flash else
              torch.ones((T, T), dtype=torch.bool, device=x.device).tril()[None, None])
    dec_lora = lora.get("decoder") if lora else None
    ctx = lora_ctx(dec_lora, adapter_idx, lora_scale, dtype, lora_dropout,
                   dropout_seed, dropout_rows)
    heads = decoder_heads(params, cfg)

    act = decoder_act(cfg)

    def body(x, l):
        return _dec_layer_apply(x, enc_out, _layer(dec["layers"], l),
                                _layer(dec_lora, l) if dec_lora else None,
                                _layer_ctx(ctx, l), heads, causal,
                                flash=flash, tp=tp, act=act, eps=cfg.ln_eps)
    body = _remat(body, remat)
    for l in range(cfg.decoder_layers):
        x = body(x, l)
    x = layer_norm(x, dec["ln"]["scale"], dec["ln"]["bias"], cfg.ln_eps)
    return _logits(x, dec, cfg, tp)


def detect_language(params: Params, enc_out: torch.Tensor,
                    cfg: WhisperConfig,
                    tp: ModelGroup | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-shot language ID from the model itself (openai-whisper's
    `detect_language`): the decoder sees only `<|sot|>` and its next-token
    distribution is renormalized over the language tokens. Returns
    (lang_index [B] int64 into WHISPER_LANGUAGES, probs [B, n_langs] fp32).
    Meaningful with real multilingual weights only."""
    from sar_tpu_torch.models.config import WHISPER_LANGUAGES
    B = enc_out.shape[0]
    sot = torch.full((B, 1), cfg.sot_token_id, dtype=torch.int64,
                     device=enc_out.device)
    logits = decode_train(params, enc_out, sot, cfg, tp=tp)[:, 0]
    n = min(len(WHISPER_LANGUAGES), cfg.vocab_size - cfg.lang_token_offset)
    lang_logits = logits[:, cfg.lang_token_offset:cfg.lang_token_offset + n].float()
    probs = torch.softmax(lang_logits, dim=-1)
    return torch.argmax(probs, dim=-1), probs


def decode_cross_attn(params: Params, enc_out: torch.Tensor,
                      tokens: torch.Tensor, cfg: WhisperConfig, *,
                      heads: tuple[tuple[int, int], ...],
                      lora: Params | None = None, adapter_idx=None,
                      lora_scale: float = 1.0,
                      with_token_probs: bool = False,
                      tp: ModelGroup | None = None):
    """Teacher-forced decoder forward returning the cross-attention
    probabilities of the selected (layer, head) pairs: [B, len(heads), T, S]
    fp32, ordered like `heads` (the word aligner's capture, openai's
    find_alignment). Exact attention, as `_dec_layer_apply` without kernels:
    the blockwise kernels never hold the probabilities. Each layer keeps
    only its selected heads' maps (a copy), so the full [B, H, T, S]
    probabilities of a layer die with it.

    `with_token_probs=True` also returns [B, T] fp32: the probability of
    tokens[:, t + 1] given the prefix (0 at T - 1), gathered then
    normalized by the row's logsumexp (one logit read per position, no
    second [B, T, V] softmax).

    Under `tp` (a tensor-parallel shard) each rank keeps the maps of the
    selected heads it holds and zeros for the others, and the maps are
    summed over "model"."""
    dec = params["decoder"]
    dtype = enc_out.dtype
    T = tokens.shape[1]
    x = (embed_tokens(dec, tokens, cfg.vocab_size, tp).to(dtype)
         + dec["pos_embed"][:T].to(dtype))
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()[None, None]
    dec_lora = lora.get("decoder") if lora else None
    ctx = lora_ctx(dec_lora, adapter_idx, lora_scale, dtype)
    H = decoder_heads(params, cfg)
    h0 = 0 if tp is None else tp.rank * H            # this rank's first head
    scaling = (cfg.d_model // cfg.decoder_heads) ** -0.5
    by_layer: dict[int, list[tuple[int, int]]] = {}
    for idx, (l, h) in enumerate(heads):
        if h0 <= h < h0 + H:
            by_layer.setdefault(l, []).append((idx, h - h0))
    captured: list[torch.Tensor | None] = [None] * len(heads)
    act, eps = decoder_act(cfg), cfg.ln_eps
    for l in range(cfg.decoder_layers):
        p = _layer(dec["layers"], l)
        lo = _layer(dec_lora, l) if dec_lora else {}
        # Self-attention (causal), as _dec_layer_apply.
        h_ = layer_norm(x, p["self_ln"]["scale"], p["self_ln"]["bias"], eps)
        q = _proj(h_, p["self_q"], lo.get("self_q"), ctx, 0, tp) * scaling
        k = _proj(h_, p["self_k"], lo.get("self_k"), ctx, 1, tp)
        v = _proj(h_, p["self_v"], lo.get("self_v"), ctx, 2, tp)
        a = attention(split_heads(q, H), split_heads(k, H), split_heads(v, H), causal)
        x = x + _row_proj(merge_heads(a), p["self_o"], lo.get("self_o"), ctx, 3, tp)
        # Cross-attention, the selected heads' probabilities kept.
        h_ = layer_norm(x, p["cross_ln"]["scale"], p["cross_ln"]["bias"], eps)
        q = _proj(h_, p["cross_q"], lo.get("cross_q"), ctx, 4, tp) * scaling
        k = _proj(enc_out, p["cross_k"], lo.get("cross_k"), ctx, 5, tp)
        v = _proj(enc_out, p["cross_v"], lo.get("cross_v"), ctx, 6, tp)
        qh, kh, vh = (split_heads(t, H) for t in (q, k, v))
        probs = torch.softmax(torch.matmul(qh.float(), kh.float().transpose(-1, -2)),
                              dim=-1)
        for idx, hh in by_layer.get(l, ()):
            captured[idx] = probs[:, hh].clone()
        a = torch.matmul(probs.to(qh.dtype), vh)
        del probs
        x = x + _row_proj(merge_heads(a), p["cross_o"], lo.get("cross_o"), ctx, 7, tp)
        # MLP.
        h_ = layer_norm(x, p["mlp_ln"]["scale"], p["mlp_ln"]["bias"], eps)
        x = x + _row_linear(act(linear(h_, p["fc1"])), p["fc2"], tp)
    if tp is not None:
        zero = torch.zeros((x.shape[0], T, enc_out.shape[1]), device=x.device)
        maps = model_sum(torch.stack([zero if m is None else m for m in captured],
                                     dim=1), tp)
    else:
        maps = torch.stack(captured, dim=1)
    if not with_token_probs:
        return maps
    xf = layer_norm(x, dec["ln"]["scale"], dec["ln"]["bias"], eps)
    logits = _logits(xf, dec, cfg, tp)
    nxt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    chosen = torch.gather(logits, -1, nxt[..., None])[..., 0]
    token_probs = torch.exp(chosen - torch.logsumexp(logits, dim=-1))
    token_probs[:, -1] = 0.0
    return maps, token_probs


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


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       count: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross entropy over the positions whose label is not -100: their
    summed nll over their count, or over `count` when given (a batch
    shard's share of the global mean, `count` the global batch's)."""
    mask = labels != -100
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum() / (mask.sum() if count is None else count).clamp_min(1)


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
                   self_kv_int4: bool = False, scores_int8: bool = False,
                   mesh=None) -> bool:
    """The default cross-KV layout of a decode path: head-minor slabs (the
    layout K3, K5 and K7 stream) for a full int8 KV cache, the classic
    layout for int4 packing on either side, an unquantized side or a
    device `mesh` (as in the JAX package: mesh decodes keep the classic
    layout). `scores_int8` is the JAX package's argument and changes
    nothing here, as on its accelerator: the s8 scores take the head-minor
    slabs too. The classic int8 layout (the JAX package's choice on a CPU
    without scores_int8, and under meshes) is built only when
    `init_cache(head_minor=False)` asks for it."""
    return (mesh is None and cross_kv_int8 and self_kv_int8
            and not (cross_kv_int4 or self_kv_int4))


_PRECISIONS = ("plain", "int8", "int4")
# A classic-layout cache named by the precisions of its cross and self
# sides ("cross/self"), and the int8 head-minor cache of serving.
CACHE_KINDS = (*(f"{c}/{s}" for c in _PRECISIONS for s in _PRECISIONS),
               "int8_head_minor")


def _precision(int8: bool, int4: bool) -> str:
    """One side's precision: its int4 flag wins over its int8 flag."""
    return "int4" if int4 else "int8" if int8 else "plain"


def cache_kind(*, cross_kv_int8: bool = False, self_kv_int8: bool = False,
               cross_kv_int4: bool = False, self_kv_int4: bool = False,
               head_minor: bool | None = None) -> str:
    """The cache the flags ask for, one of CACHE_KINDS. Each side, cross
    and self, is plain (the compute dtype), int8 or int4 by its own flags,
    as in the JAX package: "plain/plain" is the default, "int8/plain" an
    int8 cross cache beside an unquantized self cache. Both int8 flags and
    no int4 flag give "int8_head_minor" (the layout K2-K5 and K7 use)
    unless head_minor=False asks for the classic "int8/int8". `head_minor`
    defaults to `use_head_minor`'s choice; head_minor=True needs both int8
    flags and no int4 flag."""
    if head_minor is None:
        head_minor = use_head_minor(cross_kv_int8=cross_kv_int8,
                                    self_kv_int8=self_kv_int8,
                                    cross_kv_int4=cross_kv_int4,
                                    self_kv_int4=self_kv_int4)
    if head_minor and (cross_kv_int4 or self_kv_int4):
        raise ValueError("head_minor (the s8-kernel layout) does not support "
                         "int4 packing")
    if head_minor and not (cross_kv_int8 and self_kv_int8):
        raise ValueError("head_minor requires an int8 KV cache "
                         "(cross_kv_int8 and self_kv_int8)")
    if head_minor:
        return "int8_head_minor"
    return (f"{_precision(cross_kv_int8, cross_kv_int4)}/"
            f"{_precision(self_kv_int8, self_kv_int4)}")


def _cache_precisions(kind: str) -> tuple[str, str]:
    """The (cross, self) precisions of a cache kind (CACHE_KINDS)."""
    if kind not in CACHE_KINDS:
        raise ValueError(f"cache kind {kind!r} not in {CACHE_KINDS}")
    if kind == "int8_head_minor":
        return "int8", "int8"
    cross, self_ = kind.split("/")
    return cross, self_


def empty_cache(cfg: WhisperConfig, batch: int, frames: int, max_len: int, *,
                kind: str, self_batch: int | None = None,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cpu",
                heads: int | None = None) -> DecodeCache:
    """An uninitialised DecodeCache of `kind` (CACHE_KINDS) for `batch`
    samples of `frames` encoder frames, `self_batch` (default `batch`)
    self-cache rows of `max_len` positions; `dtype` is the compute dtype
    (a plain side's); `heads` (default all) the decoder heads it holds
    (a rank's share under tensor parallelism). Each side has the JAX
    package's fields for its precision: K/V in the compute dtype and no
    scales (plain), or s8 values ([.., hd], or [.., hd/2] nibble-packed for
    int4) with fp32 scales per row. `init_cache(out=)` fills it."""
    cross_p, self_p = _cache_precisions(kind)
    L, H = cfg.decoder_layers, heads or cfg.decoder_heads
    hd = cfg.d_model // cfg.decoder_heads
    SB = batch if self_batch is None else self_batch

    def new(shape, dt):
        return torch.empty(shape, dtype=dt, device=device)

    def side(p, rows):
        """(K, V, K scales, V scales) of a classic side of precision `p`
        over `rows` ([L, B, H, T])."""
        if p == "plain":
            return new((*rows, hd), dtype), new((*rows, hd), dtype), None, None
        vals = (*rows, hd // 2 if p == "int4" else hd)
        return (new(vals, torch.int8), new(vals, torch.int8),
                new(rows, torch.float32), new(rows, torch.float32))

    if kind == "int8_head_minor":
        S = cross_pad_len(frames)
        ck, cv = (new((L, batch, S, H * hd), torch.int8) for _ in range(2))
        cks, cvs = (new((L, batch, H, S), torch.float32) for _ in range(2))
    else:
        ck, cv, cks, cvs = side(cross_p, (L, batch, H, frames))
    sk, sv, sks, svs = side(self_p, (L, SB, H, max_len))
    return DecodeCache(self_k=sk, self_v=sv, cross_k=ck, cross_v=cv,
                       cross_k_scale=cks, cross_v_scale=cvs,
                       self_k_scale=sks, self_v_scale=svs)


def init_cache(params: Params, enc_out: torch.Tensor, cfg: WhisperConfig,
               max_len: int, *, lora: Params | None = None,
               adapter_idx=None, lora_scale: float = 1.0,
               cross_kv_int8: bool = False,
               self_kv_int8: bool = False, head_minor: bool | None = None,
               self_batch: int | None = None,
               kernels: bool = True, cross_kv_int4: bool = False,
               self_kv_int4: bool = False,
               out: DecodeCache | None = None,
               tp: ModelGroup | None = None) -> DecodeCache:
    """The decode cache of `enc_out`: cross K/V projected once per batch
    and a zeroed self cache of `max_len` positions. By default, as in the
    JAX package, the unquantized classic cache (`_init_cache_classic`, plain
    torch, cross K/V [L, B, H, S, hd] in the compute dtype). With
    cross_kv_int8 = self_kv_int8 = True, the int8 head-minor cache of
    serving: cross K/V projected and quantized by kernel K2
    (fused_kv_init) into head-minor slabs, an int8 self cache. Otherwise
    the classic layout (plain torch, as the JAX package's jnp body), each
    side at its own precision (`cache_kind`): the cross K/V quantized per
    row by the cross flags (int8 [L, B, H, S, hd] or nibble-packed int4
    [.., hd/2], scales [L, B, H, S]), the self cache allocated by the self
    flags; an int4 flag wins over its side's int8 flag. So the int8 flags
    with head_minor=False give the JAX package's classic int8 cache, which
    `decode_step` reads through `_attention_int8`, and one side may stay
    unquantized beside a quantized other (the mixed pairs).

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

    `out` (an `empty_cache` of the same kind and shapes) is written in
    place and returned: the static cache a decode runner owns
    (decode/graphs.py), the counterpart of the JAX package donating the
    cache into its decode program, so that no second cache is alive beside
    it. Its self cache and scales are zeroed, as a new one's are.

    `head_minor` defaults to `use_head_minor`'s choice; head_minor=True
    without both int8 flags, or with an int4 flag, raises.

    `tp` (the "model" group of a tensor-parallel shard of `params`): the
    cache holds this rank's heads, in a classic layout (the decode kernels
    take whole slabs, as the JAX package's have no SPMD rule); the
    head-minor layout raises there."""
    kind = cache_kind(cross_kv_int8=cross_kv_int8, self_kv_int8=self_kv_int8,
                      cross_kv_int4=cross_kv_int4, self_kv_int4=self_kv_int4,
                      head_minor=head_minor)
    if tp is not None and kind == "int8_head_minor":
        raise ValueError("the int8 head-minor cache is not built under tensor "
                         "parallelism: pass head_minor=False (the classic "
                         "layout, as the JAX package decodes under a mesh)")
    B, S, _ = enc_out.shape
    H = decoder_heads(params, cfg)
    want = empty_cache(cfg, B, S, max_len, kind=kind, self_batch=self_batch,
                       dtype=enc_out.dtype, device="meta", heads=H)
    if out is None:
        out = empty_cache(cfg, B, S, max_len, kind=kind, self_batch=self_batch,
                          dtype=enc_out.dtype, device=enc_out.device, heads=H)
    for name, w in want._asdict().items():
        o = getattr(out, name)
        if (o is None) != (w is None) or (o is not None and (
                o.shape != w.shape or o.dtype != w.dtype
                or o.device != enc_out.device or not o.is_contiguous())):
            raise ValueError(f"init_cache: out.{name} is not a contiguous "
                             f"{kind} cache field of {tuple(w.shape) if w is not None else None} "
                             f"on {enc_out.device}")
    for t in (out.self_k, out.self_v, out.self_k_scale, out.self_v_scale):
        if t is not None:
            t.zero_()
    if kind != "int8_head_minor":
        _init_cache_classic(params, enc_out, cfg, out, lora=lora,
                            adapter_idx=adapter_idx, lora_scale=lora_scale,
                            cross=_cache_precisions(kind)[0], tp=tp)
        return out
    dec = params["decoder"]
    pad = cross_pad_len(S) - S
    enc_pad = F.pad(enc_out, (0, 0, 0, pad)) if pad else enc_out.contiguous()
    lay = dec["layers"]
    dec_lora = lora.get("decoder") if lora else None
    slabs = (out.cross_k, out.cross_k_scale, out.cross_v, out.cross_v_scale)
    if dec_lora is not None and "cross_k" in dec_lora:
        _cross_kv_torch(enc_pad, lay, dec_lora, H, S,
                        lora_ctx(dec_lora, adapter_idx, lora_scale, enc_pad.dtype),
                        slabs)
        return out
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
    fn(enc_pad, lay["cross_k"]["w"], lay["cross_v"]["w"], lay["cross_v"]["b"],
       n_heads=H, t_valid=S, out=slabs, **kw)
    return out


def _init_cache_classic(params: Params, enc_out: torch.Tensor,
                        cfg: WhisperConfig, out: DecodeCache, *,
                        lora: Params | None = None, adapter_idx=None,
                        lora_scale: float = 1.0,
                        cross: str = "plain",
                        tp: ModelGroup | None = None) -> None:
    """The cross fields of a classic-layout cache `out` (plain torch, as the
    JAX package's jnp body): each layer's (adapted) projection of `enc_out`
    split into heads, cross K/V [L, B, H, S, hd] in the compute dtype at
    precision `cross` "plain"; with "int8", quantized per row by
    `quantize_kv` (s8, fp32 scales [.., S]); with "int4", nibble-packed by
    `quantize_kv4` ([.., hd/2] s8). The self side is not touched here.
    Written layer by layer into `out`, as the JAX package's scan body
    quantizes per layer: the fp32 temporaries of one layer, not of the
    whole stack. Under `tp`, this rank's heads."""
    lay = params["decoder"]["layers"]
    H = decoder_heads(params, cfg)
    dec_lora = lora.get("decoder") if lora else None
    ctx = lora_ctx(dec_lora, adapter_idx, lora_scale, enc_out.dtype)
    quantize = quantize_kv4 if cross == "int4" else quantize_kv
    for l in range(lay["cross_k"]["w"].shape[0]):
        p, lo = _layer(lay, l), (_layer(dec_lora, l) if dec_lora else {})
        k = split_heads(_proj(enc_out, p["cross_k"], lo.get("cross_k"), ctx, 5, tp), H)
        v = split_heads(_proj(enc_out, p["cross_v"], lo.get("cross_v"), ctx, 6, tp), H)
        if cross != "plain":
            (k, out.cross_k_scale[l]), (v, out.cross_v_scale[l]) = quantize(k), quantize(v)
        out.cross_k[l], out.cross_v[l] = k, v


def _cross_kv_torch(enc_pad, lay, dec_lora, n_heads, t_valid, ctx, out):
    """Cross K/V of every layer through `_proj` (LoRA on cross_k and/or
    cross_v) and `quantize_rows`, into the head-minor slabs `out` (kq, ks,
    vq, vs): the cache build of banks that adapt cross_k, which K4 does
    not take."""
    kq, ks, vq, vs = out
    for l in range(lay["cross_k"]["w"].shape[0]):
        p, lo = _layer(lay, l), _layer(dec_lora, l)
        kq[l], ks[l] = quantize_rows(_proj(enc_pad, p["cross_k"], lo.get("cross_k"), ctx),
                                     n_heads, t_valid)
        vq[l], vs[l] = quantize_rows(_proj(enc_pad, p["cross_v"], lo.get("cross_v"), ctx),
                                     n_heads, t_valid)


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
    """The fp32 [V, d] weight of the logits (see cast_params): the token
    embedding, or, where the logits are untied (an output layer "out" of
    [d, V] with a bias, which `_logits` adds), that layer's transpose."""
    if "out" in dec:
        w = dec["out"]["w"]
        return (w if w.dtype == torch.float32 else dec["out_f32"]).T
    emb = dec["token_embed"]
    return emb if emb.dtype == torch.float32 else dec["token_embed_f32"]


def decode_step(params: Params, tokens: torch.Tensor, pos: int,
                cache: DecodeCache, cfg: WhisperConfig, *,
                lora: Params | None = None, adapter_idx=None,
                lora_scale: float = 1.0, scores_int8: bool = False,
                beam_width: int = 1, ancestry: torch.Tensor | None = None,
                kernels: bool = True,
                self_len: int | None = None,
                tp: ModelGroup | None = None) -> tuple[torch.Tensor, DecodeCache]:
    """One autoregressive step. tokens: [B] int64 at position `pos` (< the
    self cache's max_len). Returns (logits [B, V] fp32, cache), the self
    cache updated in place at column `pos`.

    `self_len` (pos < self_len <= max_len; default max_len): the
    self-attention reads only the first `self_len` rows of the self cache
    and its scales (a view, the position mask cut to match), as the JAX
    package's segment buffers of hi_s = min((s + 1) * segment, total) rows
    do (decode/greedy.py). Every self-attention form takes it: the plain,
    int8, s8 and int4 reads and the beams' ancestry read. Nothing in a step
    copies from the host or waits for the device, so that a decode runner
    can capture it (decode/graphs.py): `adapter_idx` and `ancestry` are
    device tensors there.

    The self and the cross sides are dispatched apart, as in the JAX
    package, each from its own fields' shapes and `None`-ness (so a mixed
    cache, one side quantized and the other not or at another precision,
    reads each side as its own): a side without scales by plain
    `attention`, an int4 side (told apart by its hd/2 axis) by
    `_attention_int4`, a classic int8 side by `_attention_int8`
    (`_attention_int8_mxu` with `scores_int8`). The int8 self side, without
    `scores_int8` or `ancestry` and with kernels=True, goes through
    ops/decode_self_exact.py (kernel K11 on the card, `_attention_int8` on
    the CPU). The cross path over the int8 head-minor cache (4-d slabs)
    goes through a decode kernel (ops/decode_cross.py): K3/K5, or K7 with
    `scores_int8`; `kernels=False` runs the kernels' plain versions on any
    device. `scores_int8` needs both sides int8; `ancestry` takes no int4
    self side.
    `lora` adapts the decoder hooks it holds (self_q/k/v/o, cross_q/o;
    cross_k/v live in the cache), per row when `adapter_idx` is given.

    The LayerNorms and residual adds go through ops/layer_norm.py where
    kernels=True and the rows are bf16 of a width the kernels take: the
    first LayerNorm by `layer_norm` (K13 on the card) and each sublayer
    boundary (self_o, cross_o, fc2 added to the residual, then the next
    LayerNorm) by `add_layer_norm` (K14 on the card), which also adds the
    projection's bias unless a LoRA term follows it (`_row_proj_parts`).
    Otherwise, and on the CPU, they are the plain chain, bit for bit.

    `beam_width` K > 1: rows are beam-major groups of K per sample (row
    b*K+k = sample b, beam k) over a cache whose cross slabs hold ONE copy
    per sample; the K queries of a sample are folded into one cross call
    (q [B/K, K, D], kernel K5 or K7; [B/K, H, K, hd] query rows of plain
    attention over the classic cache), so each slab is read once for its
    beams. `ancestry` [B/K, K, max_len] (beam mode only, not with int4 or
    scores_int8, whose beams reorder the self cache) reads the self cache as
    slot-major (`_self_attention_beam`); its column `pos` must be the
    identity, since each beam writes its own slot at this step.

    `tp` (the "model" group of a tensor-parallel shard of `params`, over a
    classic cache of this rank's heads from `init_cache(tp=)`): the
    row-parallel products are summed over the group and the logits
    gathered, so every rank of the group returns the same logits."""
    H = cache.self_k.shape[2]                  # this rank's heads under tp
    hd = cfg.d_model // cfg.decoder_heads
    half = hd // 2
    self_plain = cache.self_k_scale is None
    self_int4 = not self_plain and cache.self_k.shape[-1] == half
    cross_plain = cache.cross_k_scale is None
    cross_classic = cache.cross_k.dim() == 5     # else the head-minor slabs
    cross_int4 = not cross_plain and cross_classic and cache.cross_k.shape[-1] == half
    if scores_int8 and (self_plain or cross_plain):
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
    max_len = cache.self_k.shape[3]
    n = max_len if self_len is None else self_len
    if not pos < n <= max_len:
        raise ValueError(f"self_len {n} must hold position {pos} and fit the "
                         f"self cache's {max_len} rows")
    dec = params["decoder"]
    dtype = dec["token_embed"].dtype
    x = embed_tokens(dec, tokens, cfg.vocab_size, tp)[:, None, :].to(dtype)  # [B, 1, d]
    x = x + dec["pos_embed"][pos].to(dtype)
    pos_mask = (torch.arange(n, device=x.device) <= pos)[None, None, None, :]
    scaling = hd ** -0.5
    cross = cross_decode_attention_exact if kernels else cross_decode_reference_exact
    self_attn = (_attention_int4 if self_int4 else
                 _attention_int8_mxu if scores_int8 else _attention_int8)
    self_kernel = kernels and not (self_plain or self_int4 or scores_int8)
    quant = quantize_kv4 if self_int4 else quantize_kv
    dec_lora = lora.get("decoder") if lora else None
    ctx = lora_ctx(dec_lora, adapter_idx, lora_scale, dtype)
    act, eps = decoder_act(cfg), cfg.ln_eps
    fused = kernels and dtype == torch.bfloat16 and ln_ops.kernel_takes(x.shape[-1])
    norm = ln_ops.layer_norm if fused else layer_norm
    add_norm = ln_ops.add_layer_norm if fused else ln_ops.add_layer_norm_reference
    L = cache.self_k.shape[0]
    lns = dec["layers"]
    h = norm(x, lns["self_ln"]["scale"][0], lns["self_ln"]["bias"][0], eps)

    for l in range(L):
        p = _layer(lns, l)
        lo = _layer(dec_lora, l) if dec_lora else {}
        # Self-attention against the cache (row `pos` written first).
        q = _proj(h, p["self_q"], lo.get("self_q"), ctx, tp=tp) * scaling
        k = split_heads(_proj(h, p["self_k"], lo.get("self_k"), ctx, tp=tp), H)
        v = split_heads(_proj(h, p["self_v"], lo.get("self_v"), ctx, tp=tp), H)
        # The first n rows of layer l's self cache (all of it by default).
        sk, sv = cache.self_k[l, :, :, :n], cache.self_v[l, :, :, :n]
        if self_plain:
            cache.self_k[l, :, :, pos] = k[:, :, 0]
            cache.self_v[l, :, :, pos] = v[:, :, 0]
            if ancestry is not None:
                a = _self_attention_beam(split_heads(q, H), sk, sv, None, None,
                                         ancestry, pos, beam_width)
            else:
                a = attention(split_heads(q, H), sk, sv, mask=pos_mask)
        else:
            kq, ks = quant(k)
            vq, vs = quant(v)
            cache.self_k[l, :, :, pos] = kq[:, :, 0]
            cache.self_v[l, :, :, pos] = vq[:, :, 0]
            cache.self_k_scale[l, :, :, pos] = ks[:, :, 0]
            cache.self_v_scale[l, :, :, pos] = vs[:, :, 0]
            sks, svs = cache.self_k_scale[l, :, :, :n], cache.self_v_scale[l, :, :, :n]
            if ancestry is not None:
                a = _self_attention_beam(split_heads(q, H), sk, sv, sks, svs,
                                         ancestry, pos, beam_width)
            elif self_kernel:
                a = self_decode_attention_exact(
                    split_heads(q, H), cache.self_k, cache.self_k_scale,
                    cache.self_v, cache.self_v_scale, layer=l, pos=pos, n=n)
            else:
                a = self_attn(split_heads(q, H), sk, sks, sv, svs, mask=pos_mask)
        x, h = add_norm(x, *_row_proj_parts(merge_heads(a), p["self_o"], lo.get("self_o"),
                                            ctx, tp),
                        p["cross_ln"]["scale"], p["cross_ln"]["bias"], eps)
        # Cross-attention: exact over an unquantized classic side, int4 or
        # int8 over the quantized classic slabs, or over the head-minor int8
        # slabs of layer l (K3/K5 exact, K7 with scores_int8); beam queries
        # are folded per sample ([B/K, K, ...]) when beam_width > 1.
        q = _proj(h, p["cross_q"], lo.get("cross_q"), ctx, tp=tp) * scaling
        if cross_plain:
            # The K beam queries of a sample ride its one cross slab as K
            # query rows ([B/K, H, K, hd]), unfolded after.
            qh = q.reshape(B // beam_width, beam_width, H, -1).transpose(1, 2)
            a = attention(qh, cache.cross_k[l], cache.cross_v[l])
            o = a.transpose(1, 2).reshape(B, 1, -1)
        elif cross_classic:
            qh = q.reshape(B // beam_width, beam_width, H, -1).transpose(1, 2)
            attn = (_attention_int4 if cross_int4 else
                    _attention_int8_mxu if scores_int8 else _attention_int8)
            a = attn(qh, cache.cross_k[l], cache.cross_k_scale[l],
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
        x, h = add_norm(x, *_row_proj_parts(o.reshape(B, 1, -1), p["cross_o"],
                                            lo.get("cross_o"), ctx, tp),
                        p["mlp_ln"]["scale"], p["mlp_ln"]["bias"], eps)
        # MLP, then the next layer's self_ln (the final ln after the last).
        h = act(linear(h, p["fc1"]))
        ln = _layer(lns["self_ln"], l + 1) if l + 1 < L else dec["ln"]
        x, h = add_norm(x, *_row_proj_parts(h, p["fc2"], None, ctx, tp),
                        ln["scale"], ln["bias"], eps)
    return _logits(h[:, 0], dec, cfg, tp), cache
