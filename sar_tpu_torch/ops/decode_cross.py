"""Cross-attention decode step over the int8 head-minor cache (kernel K3)
and its plain PyTorch version.

Counterpart of sar_tpu/ops/decode_cross.py::cross_decode_attention_exact
for beam_width 1: scores = (q.k)*ks over layer `layer`'s slab of the FULL
stacked cache, masked where ks <= 0 (layout padding), fp32 softmax,
pw = (p*vs) in q's dtype, out = sum pw*v with fp32 accumulation. q and the
probabilities are never quantized.

`cross_decode_attention_exact` dispatches on the tensors' device: CPU
tensors take `cross_decode_reference_exact`; CUDA tensors launch the
hand-written kernel (csrc/decode_cross.cu) or raise. The kernel takes a
bf16 q, head_dim 64 and S_pad a multiple of 64; the layer is an offset into
the stacked cache (nothing is sliced or copied per step).
"""

from __future__ import annotations

import torch

from sar_tpu_torch.ops import _build

NEG = -1e30
KERNEL_HEAD_DIM = 64
KERNEL_ROW_GROUPS = 64

LAUNCHES = 0  # kernel launches by cross_decode_attention_exact (CUDA only)


def cross_decode_reference_exact(q, kq, ks, vq, vs, *, layer: int,
                                 n_heads: int, out_dtype=None) -> torch.Tensor:
    """Plain version: q [B, D]; kq/vq [L, B, S_pad, D] int8; ks/vs
    [L, B, H, S_pad] fp32 -> [B, D] in `out_dtype` (default q's dtype)."""
    kq, ks, vq, vs = kq[layer], ks[layer], vq[layer], vs[layer]
    H = n_heads
    cdt = q.dtype
    B, D = q.shape
    hd = D // H
    S = kq.shape[1]
    qf = q.reshape(B, H, hd).float()
    st = torch.einsum("bhd,bshd->bhs", qf, kq.reshape(B, S, H, hd).float()) * ks
    st = torch.where(ks > 0, st, NEG)
    p = torch.softmax(st, dim=-1)
    pw = (p * vs).to(cdt).float()
    o = torch.einsum("bhs,bshd->bhd", pw, vq.reshape(B, S, H, hd).float())
    return o.reshape(B, D).to(out_dtype or cdt)


def cross_decode_attention_exact(q, kq, ks, vq, vs, *, layer: int,
                                 n_heads: int) -> torch.Tensor:
    """q [B, D] (pre-scaled), full stacked cache kq/vq [L, B, S_pad, D] s8,
    ks/vs [L, B, H, S_pad] f32 -> [B, D] in q's dtype."""
    if q.device.type == "cpu":
        return cross_decode_reference_exact(q, kq, ks, vq, vs, layer=layer,
                                            n_heads=n_heads)
    global LAUNCHES
    name = "cross_decode_attention_exact"
    _build.require(q.device.type == "cuda",
                   f"{name}: no kernel for device {q.device}")
    _build.require_cuda_args(
        name, dict(q=q, kq=kq, ks=ks, vq=vq, vs=vs),
        dict(q=torch.bfloat16, kq=torch.int8, ks=torch.float32,
             vq=torch.int8, vs=torch.float32))
    B, D = q.shape
    L, _, S, _ = kq.shape
    _build.require(q.dim() == 2 and kq.shape == (L, B, S, D)
                   and vq.shape == kq.shape
                   and ks.shape == (L, B, n_heads, S) and vs.shape == ks.shape,
                   f"{name}: want q [B, D], kq/vq [L, B, S_pad, D], "
                   f"ks/vs [L, B, H, S_pad]")
    _build.require(D == n_heads * KERNEL_HEAD_DIM,
                   f"{name}: the kernel takes head_dim {KERNEL_HEAD_DIM}, "
                   f"got D={D} with {n_heads} heads")
    _build.require(S % KERNEL_ROW_GROUPS == 0,
                   f"{name}: S_pad={S} must be a multiple of "
                   f"{KERNEL_ROW_GROUPS}")
    _build.require(0 <= layer < L, f"{name}: layer {layer} not in [0, {L})")
    out = torch.empty_like(q)
    lib = _build.load()
    _build.check(lib.sar_cross_decode_exact(
        q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), out.data_ptr(), L, B, S, D, n_heads, layer,
        q.device.index, _build.stream_of(q)), name)
    LAUNCHES += 1
    return out
