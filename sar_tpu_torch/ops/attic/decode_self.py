"""s8 self-attention decode step over head-minor int8 slabs (kernel K9)
and its plain PyTorch version.

Counterpart of sar_tpu/ops/attic/decode_self.py::self_decode_attention, a
parked experiment of the JAX package with no caller there, and none here
(`decode_step` keeps the classic self cache). One decode step for a
batch: the pre-scaled query quantized per (row, head) (qq [B, D] s8, qs
[B, H, 1] fp32) against layer `layer` of the FULL stacked cache (kq/vq
[L, B, max_len, D] s8, ks/vs [L, B, H, max_len] fp32, head h at columns
h*hd .. h*hd+hd-1): scores = (qq.kq) * qs * ks with an exact integer dot,
positions >= valid_len masked, an fp32 softmax normalised BEFORE
pw = p * vs, pw re-quantized per (row, head) to s8 (ps = max|pw|/127,
round half to even) and out = (pq.vq) * ps with an exact integer sum.
valid_len (pos + 1) is dynamic: a Python int or a 0-d int32 tensor on the
cache's device, so one build serves every position.

`self_decode_attention` dispatches on the tensors' device: CPU tensors take
`self_decode_reference`; CUDA tensors launch the hand-written kernel
(csrc/decode_s8.cu, K7's kernel body with one query and the length mask)
or raise. The kernel takes head_dim 64 and any max_len, splits max_len
over a thread-block cluster of `cluster_split(max_len)` blocks per (head,
sample), and writes bf16.
"""

from __future__ import annotations

import torch

from sar_tpu_torch.ops import _build
from sar_tpu_torch.ops.decode_cross import (MAX_SHARED_BYTES, int_einsum, s8_cluster_split,
                                            s8_shared_bytes)

NEG = -1e30
KERNEL_HEAD_DIM = 64
# K9's least slice of max_len per block (csrc/decode_s8.cu,
# SAR_S8_SELF_MIN_SLICE): C is fixed by max_len at launch, n is dynamic.
MIN_SLICE = 256

LAUNCHES = 0  # K9 launches by self_decode_attention (CUDA tensors only)


def self_decode_reference(qq, qs, kq, ks, vq, vs, valid_len, *, layer: int,
                          n_heads: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """K9's plain version (the JAX package's `self_decode_reference`):
    qq [B, D] s8, qs [B, H, 1]; kq/vq [L, B, max_len, D] s8, ks/vs
    [L, B, H, max_len] fp32 -> [B, D] in `out_dtype`."""
    kq, ks, vq, vs = kq[layer], ks[layer], vq[layer], vs[layer]
    B, D = qq.shape
    H = n_heads
    hd = D // H
    S = kq.shape[1]
    st = int_einsum("bhd,bshd->bhs", qq.reshape(B, H, hd),
                    kq.reshape(B, S, H, hd)) * qs * ks
    valid = torch.as_tensor(valid_len, device=st.device)
    st = torch.where(torch.arange(S, device=st.device) < valid, st, NEG)
    p = torch.softmax(st, dim=-1)
    pw = p * vs
    ps = pw.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
    pq = torch.clamp(torch.round(pw / ps), -127, 127)
    o = int_einsum("bhs,bshd->bhd", pq, vq.reshape(B, S, H, hd)) * ps
    return o.reshape(B, D).to(out_dtype)


def cluster_split(S: int) -> tuple[int, int]:
    """(C, rows) of K9's split of max_len S over a cluster (K7's rule with
    MIN_SLICE); a block whose rows start at or past n > 0 reads nothing."""
    return s8_cluster_split(S, MIN_SLICE)


def shared_bytes(S: int) -> int:
    """K9's dynamic shared memory per block: K7's with one query over a
    slice of `cluster_split(S)` rows."""
    return s8_shared_bytes(1, S, MIN_SLICE)


def self_decode_attention(qq, qs, kq, ks, vq, vs, valid_len, *, layer: int,
                          n_heads: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """One s8 decode step of self-attention over layer `layer` of the
    head-minor cache -> [B, D] in `out_dtype`. CUDA tensors launch K9
    (bf16 output only); CPU tensors take `self_decode_reference`."""
    if qq.device.type == "cpu":
        return self_decode_reference(qq, qs, kq, ks, vq, vs, valid_len,
                                     layer=layer, n_heads=n_heads,
                                     out_dtype=out_dtype)
    global LAUNCHES
    name = "self_decode_attention (K9)"
    _build.require(qq.device.type == "cuda",
                   f"{name}: no kernel for device {qq.device}")
    _build.require_cuda_args(
        name, dict(qq=qq, qs=qs, kq=kq, ks=ks, vq=vq, vs=vs),
        dict(qq=torch.int8, qs=torch.float32, kq=torch.int8, ks=torch.float32,
             vq=torch.int8, vs=torch.float32))
    _build.require(qq.dim() == 2 and kq.dim() == 4,
                   f"{name}: want qq [B, D] and kq/vq [L, B, max_len, D]")
    B, D = qq.shape
    L, _, S, _ = kq.shape
    H = n_heads
    _build.require(kq.shape == (L, B, S, D) and vq.shape == kq.shape
                   and ks.shape == (L, B, H, S) and vs.shape == ks.shape
                   and qs.shape == (B, H, 1),
                   f"{name}: want qq [B, D], qs [B, H, 1], kq/vq "
                   f"[L, B, max_len, D], ks/vs [L, B, H, max_len]")
    _build.require(D == H * KERNEL_HEAD_DIM,
                   f"{name}: the kernel takes head_dim {KERNEL_HEAD_DIM}, "
                   f"got D={D} with {H} heads")
    _build.require(0 <= layer < L, f"{name}: layer {layer} not in [0, {L})")
    _build.require(out_dtype == torch.bfloat16,
                   f"{name}: the kernel writes bfloat16, not {out_dtype}")
    _build.require(shared_bytes(S) <= MAX_SHARED_BYTES,
                   f"{name}: max_len={S} needs {shared_bytes(S)} bytes of "
                   f"shared memory per block, more than the {MAX_SHARED_BYTES} a "
                   f"block may have")
    n_ptr, n_host = _build.valid_len_arg(name, valid_len, qq.device, S)
    out = torch.empty((B, D), dtype=torch.bfloat16, device=qq.device)
    lib = _build.load()
    _build.check(lib.sar_self_decode_s8(
        qq.data_ptr(), qs.data_ptr(), kq.data_ptr(), ks.data_ptr(),
        vq.data_ptr(), vs.data_ptr(), n_ptr, n_host, out.data_ptr(), L, B, S,
        D, H, layer, qq.device.index, _build.stream_of(qq)), name)
    LAUNCHES += 1
    return out

