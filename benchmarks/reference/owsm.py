"""Plain OWSM in float32 PyTorch: ESPnet's conv2d subsampling, the
E-Branchformer encoder and the Transformer decoder's teacher-forced logits,
written from the published architecture (Peng et al. 2024, OWSM v3.1;
Kim et al. 2022, E-Branchformer; ESPnet's e_branchformer_encoder.py,
cgmlp.py and transformer decoder), one utterance at a time, with no
kernel, no cache and no batching. Imports nothing of the program.

It reads the weights in their published form (`benchmarks/weights_owsm.py`:
every Linear with its bias, k's included, nothing folded) and an adapter
bank in the form `reference/whisper.py` takes, upcast to float32. Every
LayerNorm has eps 1e-12 (ESPnet's), every Linear a bias.

    subsampling  x [T_frames, M] -> ReLU(Conv2d 3x3 /2) twice -> flatten
                 channel-major -> Linear -> x * sqrt(d) + PE
    block        x += FFN_swish(LN x) / 2
                 a = MHSA(LN x)   (q k^T / sqrt(hd), absolute positions)
                 [r | g] = GELU(Linear(LN x));  g = DWConv(LN g)
                 c = Linear(r * g)
                 m = [a | c];  x += Linear(m + DWConv(m))
                 x += FFN_swish(LN x) / 2;  x = LN x
    decoder      x = Embedding * sqrt(d) + PE; pre-LN causal self-attention,
                 cross-attention and a ReLU FFN per layer; LN; Linear with
                 a bias (untied)

PE is ESPnet's table: even columns sin, odd columns cos, of
pos * exp(-ln(10000) * 2i / d). The depthwise convolutions pad with zeros
(kernel // 2 each side). `Precision` (reference/whisper.py) rounds the
operands of every product and convolution: float32 as they are, or the
float8 control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmarks.reference.whisper import (FP8, FP32, Adapter, Precision,  # noqa: F401
                                          _attend, _f, _proj, exact_float32)

EPS = 1e-12


def _ln(x, p, l=None):
    s, b = (p["scale"], p["bias"]) if l is None else (p["scale"][l], p["bias"][l])
    return F.layer_norm(x, (x.shape[-1],), _f(s), _f(b), eps=EPS)


def positions(length: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros(length, d, dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.float()


def _dwconv(x, p, l, prec):
    """Depthwise convolution over time of x [T, C], zero padded."""
    w = _f(p["w"][l])
    y = F.conv1d(prec.q(x.T[None]), prec.q(w), _f(p["b"][l]), padding=w.shape[-1] // 2,
                 groups=x.shape[-1])
    return y[0].T


def subsample(W, c, feats, prec=FP32):
    """feats [M, T_frames] -> [T, d] with positions."""
    e = W["encoder"]
    x = feats.float().T[None, None]
    for name in ("sub_conv1", "sub_conv2"):
        x = F.relu(F.conv2d(prec.q(x), prec.q(_f(e[name]["w"])), _f(e[name]["b"]), stride=2))
    _, C, T, Fq = x.shape
    x = x[0].permute(1, 0, 2).reshape(T, C * Fq)
    x = prec.mm(x, _f(e["sub_out"]["w"])) + _f(e["sub_out"]["b"])
    return x * math.sqrt(c["d_model"]) + positions(T, c["d_model"], x.device)


def _ffn(x, p, name, l, prec):
    h = _ln(x, p[f"{name}_ln"], l)
    return _proj(F.silu(_proj(h, p[f"{name}_up"], l, prec)), p[f"{name}_down"], l, prec)


def encode(W: dict, c: dict, feats: torch.Tensor, *, adapter: Adapter | None = None,
           prec: Precision = FP32) -> torch.Tensor:
    """One utterance's features [M, T_frames] -> encoder states [T, d]
    after the final LayerNorm."""
    x = subsample(W, c, feats, prec)
    p = W["encoder"]["layers"]
    H = c["encoder_heads"]
    hd = c["d_model"] // H
    for l in range(c["encoder_layers"]):
        x = x + 0.5 * _ffn(x, p, "ff1", l, prec)
        h = _ln(x, p["attn_ln"], l)
        q = _proj(h, p["q"], l, prec, adapter, "encoder", "q")
        k = _proj(h, p["k"], l, prec, adapter, "encoder", "k")
        v = _proj(h, p["v"], l, prec, adapter, "encoder", "v")
        a = _proj(_attend(q * hd ** -0.5, k, v, H, prec), p["o"], l, prec, adapter,
                  "encoder", "o")
        u = F.gelu(_proj(_ln(x, p["cgmlp_ln"], l), p["cgmlp_up"], l, prec))
        r, g = u.chunk(2, dim=-1)
        g = _dwconv(_ln(g, p["cgmlp_gate_ln"], l), p["cgmlp_conv"], l, prec)
        cg = _proj(r * g, p["cgmlp_down"], l, prec)
        m = torch.cat([a, cg], dim=-1)
        x = x + _proj(m + _dwconv(m, p["merge_conv"], l, prec), p["merge"], l, prec)
        x = x + 0.5 * _ffn(x, p, "ff2", l, prec)
        x = _ln(x, p["final_ln"], l)
    return _ln(x, W["encoder"]["ln"])


def decoder_logits(W: dict, c: dict, enc: torch.Tensor, tokens: torch.Tensor, *,
                   adapter: Adapter | None = None, prec: Precision = FP32) -> torch.Tensor:
    """Teacher-forced logits [T, V] of tokens [T] over encoder states enc
    [S, d]: row t scores the token after tokens[: t + 1]."""
    d = W["decoder"]
    H = c["decoder_heads"]
    hd = c["d_model"] // H
    T = tokens.shape[0]
    x = (_f(d["token_embed"][tokens]) * math.sqrt(c["d_model"])
         + positions(T, c["d_model"], enc.device))
    p = d["layers"]
    for l in range(c["decoder_layers"]):
        h = _ln(x, p["self_ln"], l)
        q = _proj(h, p["self_q"], l, prec, adapter, "decoder", "self_q")
        k = _proj(h, p["self_k"], l, prec, adapter, "decoder", "self_k")
        v = _proj(h, p["self_v"], l, prec, adapter, "decoder", "self_v")
        x = x + _proj(_attend(q * hd ** -0.5, k, v, H, prec, causal=True), p["self_o"], l,
                      prec, adapter, "decoder", "self_o")
        h = _ln(x, p["cross_ln"], l)
        q = _proj(h, p["cross_q"], l, prec, adapter, "decoder", "cross_q")
        k = _proj(enc, p["cross_k"], l, prec, adapter, "decoder", "cross_k")
        v = _proj(enc, p["cross_v"], l, prec, adapter, "decoder", "cross_v")
        x = x + _proj(_attend(q * hd ** -0.5, k, v, H, prec), p["cross_o"], l, prec,
                      adapter, "decoder", "cross_o")
        h = _ln(x, p["mlp_ln"], l)
        x = x + _proj(F.relu(_proj(h, p["fc1"], l, prec)), p["fc2"], l, prec)
    x = _ln(x, d["ln"])
    return prec.mm(x, _f(d["out"]["w"])) + _f(d["out"]["b"])
