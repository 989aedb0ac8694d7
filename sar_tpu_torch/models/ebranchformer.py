"""OWSM's encoder: ESPnet's conv2d subsampling and E-Branchformer blocks
(Kim et al. 2022; espnet2/asr/encoder/e_branchformer_encoder.py and
espnet2/asr/layers/cgmlp.py), the encoder of the configs whose
`encoder_kind` is "ebranchformer". `whisper.encode` dispatches here; the
decoder is Whisper's code path with the config's ReLU, LayerNorm eps and
untied logits (models/whisper.py). No counterpart in the JAX package.

    feats [B, 80, 3001] -> Conv2d(1->d, 3x3, /2), ReLU, Conv2d(d->d, 3x3, /2),
    ReLU -> [B, d, T, F'] flattened to [B, T, d*F'] (channel-major) ->
    Linear -> x*sqrt(d) + PE (ESPnet's interleaved sin/cos)      T = 749
    per block:  x += FFN_swish(LN x) / 2
                a = MHSA(LN x)                   (attention branch, K1)
                u = GELU(Linear(LN x)) = [r | g];  g = DWConv(LN g)
                c = Linear(r * g)                (cgMLP branch)
                m = [a | c];  x += Linear(m + DWConv(m))        (merge)
                x += FFN_swish(LN x) / 2;  x = LN x
    then a final LN.

Parameters are the port's nested dicts (linear weights [d_in, d_out],
stacked on a leading [L, ...] axis; conv weights as F.conv2d / F.conv1d
take them) in its serving form, made from the published form by
`port_params`, which applies four exact rewrites: k's bias is dropped
(it adds q.b_k to every score of a query row, which softmax removes),
sqrt(d) is folded into the subsampling's Linear and the token embedding (a
power of two at OWSM's widths, so nothing rounds), the encoder and decoder
positions are ESPnet's table in the `pos_embed` slots, and the rows of the
subsampling's Linear are put in frequency-major order, so that the second
convolution's channels-last output (the layout cuDNN computes in) feeds it
without a transpose.

The MHSA's projections are Whisper's (`whisper._enc_attention`, K1); the
other Linears take their bias in the GEMM's epilogue (`F.linear`), the
two depthwise time convolutions run with their bias, the zero padding and
the gate or the residual fused (kernel K12, ops/dwconv.py), and the
LayerNorms in one pass each (kernel K13, ops/layer_norm.py, whose plain
version `kernels=False` takes).

Padding. With flash="hm" the blocks run on T padded to `cross_pad_len(T)`
for kernel K1, which masks keys >= T. Whisper's layers are row-local
otherwise, so their pad rows may carry garbage; here the two depthwise time
convolutions would pull it into the last kernel // 2 valid frames, so they
read the pad rows as zeros (`t_valid`): the zero padding of the unpadded
convolution.

While a profiler is active the subsampling (`encode.subsample`) and each
block's cgMLP branch (`ebf.cgmlp`) and merge (`ebf.merge`) are spans
(utils/profiling.py). `BLOCKS` counts the blocks run, by frames T.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import WhisperConfig
from sar_tpu_torch.ops import dwconv, layer_norm
from sar_tpu_torch.utils import profiling

# Blocks run, by the frames T they ran over (a process-wide counter, read
# as decode/segments.py's STEPS is).
BLOCKS: dict[int, int] = {}


def positions(length: int, channels: int) -> torch.Tensor:
    """ESPnet's PositionalEncoding table [length, channels] (fp32): even
    columns sin, odd columns cos, of pos * exp(-ln(10000) * 2i / channels)."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, channels, 2, dtype=np.float64) * -(np.log(10000.0) / channels))
    pe = np.zeros((length, channels))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe.astype(np.float32))


def port_params(published: dict, cfg: WhisperConfig) -> dict:
    """The port's serving form of OWSM weights given in their published
    form (k projections with biases, no sqrt(d) folded, no position
    tables, the subsampling's Linear over channel-major features): k's
    biases dropped, sqrt(d) folded into the subsampling's Linear and the
    token embedding, ESPnet's positions in `pos_embed`, the Linear's rows
    in frequency-major order and the convolutions channels-last, all in
    the weights' dtype. The other leaves are shared, not copied."""
    enc, dec = published["encoder"], published["decoder"]
    root = cfg.d_model ** 0.5
    w = enc["sub_out"]["w"]
    dtype, dev = w.dtype, w.device
    C = enc["sub_conv2"]["w"].shape[0]

    def no_bias(p):
        return {"w": p["w"]}

    def table(n):
        return positions(n, cfg.d_model).to(device=dev, dtype=dtype)

    def channels_last(p):
        return {"w": p["w"].contiguous(memory_format=torch.channels_last), "b": p["b"]}

    rows = w.reshape(C, w.shape[0] // C, -1).transpose(0, 1).reshape(w.shape)
    return dict(
        published,
        encoder=dict(enc, layers=dict(enc["layers"], k=no_bias(enc["layers"]["k"])),
                     sub_conv1=channels_last(enc["sub_conv1"]),
                     sub_conv2=channels_last(enc["sub_conv2"]),
                     sub_out={"w": rows * root, "b": enc["sub_out"]["b"] * root},
                     pos_embed=table(cfg.max_source_positions)),
        decoder=dict(dec, layers=dict(dec["layers"],
                                      self_k=no_bias(dec["layers"]["self_k"]),
                                      cross_k=no_bias(dec["layers"]["cross_k"])),
                     token_embed=dec["token_embed"] * root,
                     pos_embed=table(cfg.max_target_positions)))


def _linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x @ w + b with the bias added in the GEMM's epilogue (one rounding
    of the fp32 sum, where `whisper.linear` rounds the product and then the
    sum)."""
    return F.linear(x, p["w"].t(), p["b"])


def subsample(enc: dict, feats: torch.Tensor) -> torch.Tensor:
    """Conv2dSubsampling (x4) with positions: feats [B, M, T_frames] ->
    [B, T, d] in the weights' dtype, T = ((T_frames - 1) // 2 - 1) // 2.
    The convolutions run channels-last; the output's frames are flattened
    frequency-major, the order `port_params` gave the Linear's rows."""
    dtype = enc["sub_out"]["w"].dtype
    # [B, 1, Tf, M] with the strides of channels-last (C's stride 1), which
    # the convolution's layout choice reads: a one-channel tensor is
    # contiguous in both layouts, and its strides decide.
    x = feats.to(dtype).transpose(1, 2).contiguous()[..., None].permute(0, 3, 1, 2)
    for name in ("sub_conv1", "sub_conv2"):
        x = F.relu_(F.conv2d(x, enc[name]["w"], enc[name]["b"], stride=2))
    B, C, T, Fq = x.shape
    x = _linear(x.permute(0, 2, 3, 1).reshape(B, T, Fq * C), enc["sub_out"])
    return x + enc["pos_embed"][:T].to(dtype)


def _norm(kernels: bool):
    """K13, or its plain version with `kernels=False`."""
    return layer_norm.layer_norm if kernels else layer_norm.layer_norm_reference


def _ln(ln, x, p, eps: float) -> torch.Tensor:
    return ln(x, p["scale"], p["bias"], eps)


def _half_ffn(x, p, name: str, ln, eps: float) -> torch.Tensor:
    """x + FFN_swish(LN x) / 2 (one rounding of the sum: halving is exact)."""
    h = _ln(ln, x, p[f"{name}_ln"], eps)
    return torch.add(x, _linear(F.silu(_linear(h, p[f"{name}_up"])), p[f"{name}_down"]),
                     alpha=0.5)


def block(x, p, n_heads: int, *, flash, t_valid: int, pad: bool, lora, ctx,
          kernels: bool, eps: float) -> torch.Tensor:
    """One E-Branchformer block over x [B, T_pad, d]: `t_valid` frames are
    real; with `pad` the depthwise convolutions read the rest as zeros.
    `lora` adapts the MHSA's q/k/v/o hooks it holds (whisper._proj /
    lora_delta). `kernels=False` takes K1's, K12's and K13's plain
    versions."""
    lo = lora or {}
    conv = dwconv.depthwise_conv_time if kernels else dwconv.depthwise_conv_time_reference
    ln = _norm(kernels)
    frames = t_valid if pad else None
    x = _half_ffn(x, p, "ff1", ln, eps)
    a = whisper._enc_attention(x, p, n_heads, flash, t_valid, lo, ctx, kernels, eps=eps,
                               norm=ln)
    a = whisper._proj(a, p["o"], lo.get("o"), ctx, 3)
    with profiling.span("ebf.cgmlp"):
        h = _ln(ln, x, p["cgmlp_ln"], eps)
        r, g = F.gelu(_linear(h, p["cgmlp_up"])).chunk(2, dim=-1)
        g = _ln(ln, g, p["cgmlp_gate_ln"], eps)
        gated = conv(g, p["cgmlp_conv"]["w"], p["cgmlp_conv"]["b"], t_valid=frames, gate=r)
        c = _linear(gated, p["cgmlp_down"])
    with profiling.span("ebf.merge"):
        m = torch.cat([a, c], dim=-1)
        merged = conv(m, p["merge_conv"]["w"], p["merge_conv"]["b"], t_valid=frames,
                      residual=True)
        x = x + _linear(merged, p["merge"])
    x = _half_ffn(x, p, "ff2", ln, eps)
    BLOCKS[t_valid] = BLOCKS.get(t_valid, 0) + 1
    return _ln(ln, x, p["final_ln"], eps)


def encode(params: dict, feats: torch.Tensor, cfg: WhisperConfig, *,
           lora: dict | None = None, adapter_idx=None, lora_scale: float = 1.0,
           lora_dropout: float = 0.0, dropout_seed: int | None = None,
           remat=False, flash: bool | str = False, kernels: bool = True,
           tp=None, dropout_rows=None) -> torch.Tensor:
    """The E-Branchformer encoder: feats [B, M, T_frames] -> [B, T, d]
    after the final LayerNorm. `flash` as whisper.encode: "hm" (and "fq",
    which has no fused form here) runs the MHSA through K1 on T padded to
    `cross_pad_len(T)`, True through K6, False exact; `kernels=False`
    takes K1's, K12's and K13's plain versions. `lora` (a bank) adapts the encoder hooks it
    holds, per row with `adapter_idx`; `lora_dropout`, `dropout_seed`,
    `dropout_rows` and `remat` as whisper.encode. Tensor parallelism is
    not implemented for this encoder (`tp` raises)."""
    if tp is not None:
        raise ValueError("the E-Branchformer encoder has no tensor-parallel form")
    if flash not in (False, True, "hm", "fq"):
        raise ValueError(f"encode(flash={flash!r}): want False, True, 'hm' or 'fq'")
    flash = "hm" if flash == "fq" else flash
    enc = params["encoder"]
    with profiling.span("encode.subsample"):
        x = subsample(enc, feats)
    T = x.shape[1]
    pad = whisper.cross_pad_len(T) - T if flash == "hm" else 0
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    enc_lora = lora.get("encoder") if lora else None
    ctx = whisper.lora_ctx(enc_lora, adapter_idx, lora_scale, x.dtype, lora_dropout,
                           dropout_seed, dropout_rows)
    eps = cfg.ln_eps

    def body(x, l):
        return block(x, whisper._layer(enc["layers"], l), cfg.encoder_heads, flash=flash,
                     t_valid=T, pad=bool(pad),
                     lora=whisper._layer(enc_lora, l) if enc_lora else None,
                     ctx=whisper._layer_ctx(ctx, l), kernels=kernels, eps=eps)
    body = whisper._remat(body, remat)
    for l in range(cfg.encoder_layers):
        x = body(x, l)
    x = x[:, :T] if pad else x
    return _ln(_norm(kernels), x, enc["ln"], eps)
