"""Plain Whisper in float32 PyTorch: the encoder, the teacher-forced decoder
and LoRA, written from the published architecture, one utterance at a time,
with no kernel, no cache and no batching. Imports nothing of the program.

It reads the weights the benchmark made (`benchmarks/weights.py`'s layout:
per-stack weights on a leading [L, ...] axis, linear weights [d_in, d_out],
convolutions [out, in, 3]) and an adapter bank in the same nested form
({"encoder": {"q": {"a": [L, A, d, r], "b": [L, A, r, d]}, ...},
"decoder": {"self_q": ..., "cross_v": ...}}), upcast to float32.

The architecture: two GELU convolutions (the second of stride 2), fixed
positions, pre-LayerNorm blocks (eps 1e-5) of self-attention and a GELU
MLP; the decoder adds learned positions to the token embedding, a causal
self-attention and a cross-attention over the encoder output per block,
a final LayerNorm and logits against the token embedding. q is scaled by
head_dim ** -0.5 after its bias; k has no bias. A LoRA hook adds
scale * (x @ A) @ B to its projection.

`Precision` rounds the operands of every product: float32 as they are
(the reference, TF32 off), or "fp8": each operand scaled per tensor into
float8 e4m3's range, rounded to it and scaled back, the control that a
step below the configuration's bfloat16 must fail.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions inside the block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


class Precision:
    """The rounding of each product's operands: None (float32) or "fp8"."""

    def __init__(self, fmt: str | None = None):
        if fmt not in (None, "fp8"):
            raise ValueError(f"precision {fmt!r}: want None or 'fp8'")
        self.fmt = fmt

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.fmt is None:
            return x
        s = E4M3_MAX / x.abs().amax().clamp_min(1e-30)
        return (x * s).to(torch.float8_e4m3fn).float() / s

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(x), self.q(w))


FP32 = Precision()
FP8 = Precision("fp8")


def _f(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def _ln(x, p, l=None):
    s, b = (p["scale"], p["bias"]) if l is None else (p["scale"][l], p["bias"][l])
    return F.layer_norm(x, (x.shape[-1],), _f(s), _f(b), eps=1e-5)


class Adapter:
    """One utterance's adapter: `bank` (or None), its index and scale."""

    def __init__(self, bank: dict | None = None, index: int = 0, scale: float = 1.0):
        self.bank, self.index, self.scale = bank, index, scale

    def delta(self, x, side: str, hook: str, l: int, prec: Precision):
        if self.bank is None or hook not in self.bank.get(side, {}):
            return None
        e = self.bank[side][hook]
        a, b = _f(e["a"][l, self.index]), _f(e["b"][l, self.index])
        return self.scale * prec.mm(prec.mm(x, a), b)


def _proj(x, p, l, prec, adapter=None, side="", hook=""):
    y = prec.mm(x, _f(p["w"][l]))
    if "b" in p:
        y = y + _f(p["b"][l])
    if adapter is not None:
        d = adapter.delta(x, side, hook, l, prec)
        if d is not None:
            y = y + d
    return y


def _attend(q, k, v, n_heads, prec, causal=False):
    """q [Tq, D], k/v [Tk, D] -> [Tq, D]; q already scaled."""
    Tq, D = q.shape
    hd = D // n_heads
    qh = q.view(Tq, n_heads, hd).transpose(0, 1)
    kh = k.view(-1, n_heads, hd).transpose(0, 1)
    vh = v.view(-1, n_heads, hd).transpose(0, 1)
    s = prec.mm(qh, kh.transpose(1, 2))
    if causal:
        mask = torch.ones(Tq, kh.shape[1], dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return prec.mm(p, vh).transpose(0, 1).reshape(Tq, D)


def encode(W: dict, c: dict, mel: torch.Tensor, *, adapter: Adapter | None = None,
           n_layers: int | None = None, prec: Precision = FP32) -> torch.Tensor:
    """One utterance's mel [M, 3000] -> encoder states [S, D] after the
    final LayerNorm, or the raw states after the first `n_layers` layers;
    the encoder reads the first 2 S frames (S = max_source_positions)."""
    e = W["encoder"]
    H = c["encoder_heads"]
    mel = mel[:, :2 * c["max_source_positions"]]
    x = F.gelu(F.conv1d(prec.q(mel.float()[None]), prec.q(_f(e["conv1"]["w"])),
                        _f(e["conv1"]["b"]), padding=1))
    x = F.gelu(F.conv1d(prec.q(x), prec.q(_f(e["conv2"]["w"])), _f(e["conv2"]["b"]),
                        stride=2, padding=1))[0].T
    x = x + _f(e["pos_embed"][:x.shape[0]])
    p = e["layers"]
    hd = c["d_model"] // H
    for l in range(c["encoder_layers"] if n_layers is None else n_layers):
        h = _ln(x, p["attn_ln"], l)
        q = _proj(h, p["q"], l, prec, adapter, "encoder", "q") * hd ** -0.5
        k = _proj(h, p["k"], l, prec, adapter, "encoder", "k")
        v = _proj(h, p["v"], l, prec, adapter, "encoder", "v")
        x = x + _proj(_attend(q, k, v, H, prec), p["o"], l, prec, adapter, "encoder", "o")
        h = _ln(x, p["mlp_ln"], l)
        x = x + _proj(F.gelu(_proj(h, p["fc1"], l, prec)), p["fc2"], l, prec)
    if n_layers is not None:
        return x
    return _ln(x, e["ln"])


def decoder_logits(W: dict, c: dict, enc: torch.Tensor, tokens: torch.Tensor, *,
                   adapter: Adapter | None = None, prec: Precision = FP32) -> torch.Tensor:
    """Teacher-forced logits [T, V] of tokens [T] over encoder states enc
    [S, D]: row t scores the token after tokens[: t + 1]."""
    d = W["decoder"]
    H = c["decoder_heads"]
    hd = c["d_model"] // H
    T = tokens.shape[0]
    x = _f(d["token_embed"][tokens]) + _f(d["pos_embed"][:T])
    p = d["layers"]
    for l in range(c["decoder_layers"]):
        h = _ln(x, p["self_ln"], l)
        q = _proj(h, p["self_q"], l, prec, adapter, "decoder", "self_q") * hd ** -0.5
        k = _proj(h, p["self_k"], l, prec, adapter, "decoder", "self_k")
        v = _proj(h, p["self_v"], l, prec, adapter, "decoder", "self_v")
        x = x + _proj(_attend(q, k, v, H, prec, causal=True), p["self_o"], l, prec,
                      adapter, "decoder", "self_o")
        h = _ln(x, p["cross_ln"], l)
        q = _proj(h, p["cross_q"], l, prec, adapter, "decoder", "cross_q") * hd ** -0.5
        k = _proj(enc, p["cross_k"], l, prec, adapter, "decoder", "cross_k")
        v = _proj(enc, p["cross_v"], l, prec, adapter, "decoder", "cross_v")
        x = x + _proj(_attend(q, k, v, H, prec), p["cross_o"], l, prec, adapter,
                      "decoder", "cross_o")
        h = _ln(x, p["mlp_ln"], l)
        x = x + _proj(F.gelu(_proj(h, p["fc1"], l, prec)), p["fc2"], l, prec)
    x = _ln(x, d["ln"])
    return prec.mm(x, _f(d["token_embed"]).T)
