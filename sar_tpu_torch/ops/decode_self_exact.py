"""Self-attention decode step over the classic int8 self cache (kernel K11)
and its plain PyTorch version.

The function of `models/whisper.py::_attention_int8` with the position
mask, as `decode_step` applies it to the first `n` (self_len) rows of layer
`layer`: scores = (fp32(q) . fp32(kq_t)) * ks_t, rows t > pos masked, an
fp32 softmax, pw_t = bf16(p_t * vs_t), out = bf16(sum_t pw_t * vq_t) with
fp32 sums. q is the pre-scaled query [B, H, 1, hd] (or [B, H*hd]); the
cache is the FULL stacked self cache (kq/vq [L, B, H, T, hd] s8, ks/vs
[L, B, H, T] fp32), the layer an offset into it, so nothing is sliced or
copied per step. Returns [B, H, 1, hd] in q's dtype.

`self_decode_attention_exact` dispatches on the tensors' device: CPU
tensors take `self_decode_reference_exact` (`_attention_int8` over the same
slice, the arithmetic of the JAX package's jnp self path); CUDA tensors
launch the hand-written kernel (csrc/decode_self_exact.cu) or raise. The
kernel takes head_dim 64, T <= 448 (Whisper's max_target_positions) and a
bf16 query, reads only rows 0..pos (the masked rows weigh exactly 0) and
writes bf16.
"""

from __future__ import annotations

import torch

from sar_tpu_torch.ops import _build

KERNEL_HEAD_DIM = 64
KERNEL_MAX_LEN = 448
LAUNCHES = 0          # K11 launches by self_decode_attention_exact (CUDA)


def self_decode_reference_exact(q, kq, ks, vq, vs, *, layer: int, pos: int,
                                n: int) -> torch.Tensor:
    """Plain version: `_attention_int8` over the first `n` rows of layer
    `layer`, masked past `pos`, as decode_step's plain path reads it.
    q [B, H, 1, hd] or [B, H*hd] -> [B, H, 1, hd]."""
    from sar_tpu_torch.models.whisper import _attention_int8
    _, B, H, _, hd = kq.shape
    mask = (torch.arange(n, device=q.device) <= pos)[None, None, None, :]
    return _attention_int8(q.reshape(B, H, 1, hd), kq[layer, :, :, :n],
                           ks[layer, :, :, :n], vq[layer, :, :, :n],
                           vs[layer, :, :, :n], mask=mask)


def self_decode_attention_exact(q, kq, ks, vq, vs, *, layer: int, pos: int,
                                n: int) -> torch.Tensor:
    """One decode step of self-attention over layer `layer` of the stacked
    int8 self cache, rows 0..pos of the first `n`: q [B, H, 1, hd] or
    [B, H*hd] (pre-scaled) -> [B, H, 1, hd]. CUDA tensors launch K11."""
    if q.device.type == "cpu":
        return self_decode_reference_exact(q, kq, ks, vq, vs, layer=layer,
                                           pos=pos, n=n)
    global LAUNCHES
    name = "self_decode_attention_exact"
    _build.require(kq.dim() == 5, f"{name}: want kq/vq [L, B, H, T, hd], got "
                   f"{tuple(kq.shape)}")
    L, B, H, T, hd = kq.shape
    _build.require(vq.shape == kq.shape and ks.shape == (L, B, H, T)
                   and vs.shape == ks.shape and q.numel() == B * H * hd,
                   f"{name}: want q [B, H, 1, hd], kq/vq [L, B, H, T, hd] and "
                   f"ks/vs [L, B, H, T]")
    _build.require(hd == KERNEL_HEAD_DIM,
                   f"{name}: the kernel takes head_dim {KERNEL_HEAD_DIM}, got {hd}")
    _build.require(T <= KERNEL_MAX_LEN,
                   f"{name}: the kernel takes at most {KERNEL_MAX_LEN} self "
                   f"cache rows, got {T}")
    _build.require(0 <= pos < n <= T,
                   f"{name}: want 0 <= pos < n <= T, got pos {pos}, n {n}, T {T}")
    _build.require(0 <= layer < L, f"{name}: layer {layer} not in [0, {L})")
    q2 = q.reshape(B, H * hd)
    _build.require_cuda_args(name, dict(q=q2, kq=kq, ks=ks, vq=vq, vs=vs),
                             dict(q=torch.bfloat16, kq=torch.int8,
                                  ks=torch.float32, vq=torch.int8,
                                  vs=torch.float32))
    out = torch.empty((B, H, 1, hd), dtype=torch.bfloat16, device=q.device)
    _build.check(_build.load().sar_self_decode_exact(
        q2.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), out.data_ptr(), L, B, H, T, hd, layer, pos,
        q.device.index, _build.stream_of(q)), name)
    LAUNCHES += 1
    return out
