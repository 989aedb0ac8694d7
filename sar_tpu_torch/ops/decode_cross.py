"""Cross-attention decode step over the int8 head-minor cache (kernels K3
and K5) and its plain PyTorch version.

Counterpart of sar_tpu/ops/decode_cross.py::cross_decode_attention_exact:
scores = (q.k)*ks over layer `layer`'s slab of the FULL stacked cache,
masked where ks <= 0 (layout padding), fp32 softmax, pw = (p*vs) in q's
dtype, out = sum pw*v with fp32 accumulation. q and the probabilities are
never quantized. q is [B, D] (greedy, K3) or beam-folded [B, K, D] (beam
search, K5): the K beam queries of a sample share its one slab, so the
slab is read once per step for all K beams.

`cross_decode_attention_exact` dispatches on the tensors' device: CPU
tensors take `cross_decode_reference_exact`; CUDA tensors launch the
hand-written kernel (csrc/decode_cross.cu) or raise. The kernels take a
bf16 q, head_dim 64 and S_pad a multiple of 64, and K5 beam widths 2..8;
the layer is an offset into the stacked cache (nothing is sliced or copied
per step).
"""

from __future__ import annotations

import torch

from sar_tpu_torch.ops import _build

NEG = -1e30
KERNEL_HEAD_DIM = 64
KERNEL_ROW_GROUPS = 64
KERNEL_BEAM_WIDTHS = range(2, 9)      # K5's template instances
# One H100 block's shared memory (227 KB) less K5's static 32-float scratch.
MAX_SHARED_BYTES = 232_448 - 128

LAUNCHES = 0       # K3 launches by cross_decode_attention_exact (CUDA, q [B, D])
BEAM_LAUNCHES = 0  # K5 launches (CUDA, beam-folded q [B, K, D])


def cross_decode_reference_exact(q, kq, ks, vq, vs, *, layer: int,
                                 n_heads: int, out_dtype=None) -> torch.Tensor:
    """Plain version: q [B, D] or beam-folded [B, K, D]; kq/vq
    [L, B, S_pad, D] int8; ks/vs [L, B, H, S_pad] fp32 -> q's shape in
    `out_dtype` (default q's dtype)."""
    kq, ks, vq, vs = kq[layer], ks[layer], vq[layer], vs[layer]
    H = n_heads
    cdt = q.dtype
    folded = q.dim() == 3
    qf = q if folded else q[:, None]
    B, K, D = qf.shape
    hd = D // H
    S = kq.shape[1]
    qf = qf.reshape(B, K, H, hd).float()
    st = torch.einsum("bkhd,bshd->bkhs", qf, kq.reshape(B, S, H, hd).float()) * ks[:, None]
    st = torch.where(ks[:, None] > 0, st, NEG)
    p = torch.softmax(st, dim=-1)
    pw = (p * vs[:, None]).to(cdt).float()
    o = torch.einsum("bkhs,bshd->bkhd", pw, vq.reshape(B, S, H, hd).float())
    o = o.reshape(B, K, D).to(out_dtype or cdt)
    return o if folded else o[:, 0]


def cross_decode_attention_exact(q, kq, ks, vq, vs, *, layer: int,
                                 n_heads: int) -> torch.Tensor:
    """q [B, D] or [B, K, D] (pre-scaled), full stacked cache kq/vq
    [L, B, S_pad, D] s8, ks/vs [L, B, H, S_pad] f32 -> q's shape in q's
    dtype. On CUDA, q [B, D] launches K3 and q [B, K, D] launches K5."""
    if q.device.type == "cpu":
        return cross_decode_reference_exact(q, kq, ks, vq, vs, layer=layer,
                                            n_heads=n_heads)
    global LAUNCHES, BEAM_LAUNCHES
    folded = q.dim() == 3
    name = ("cross_decode_attention_exact (beam-folded, K5)" if folded
            else "cross_decode_attention_exact")
    _build.require(q.device.type == "cuda",
                   f"{name}: no kernel for device {q.device}")
    _build.require_cuda_args(
        name, dict(q=q, kq=kq, ks=ks, vq=vq, vs=vs),
        dict(q=torch.bfloat16, kq=torch.int8, ks=torch.float32,
             vq=torch.int8, vs=torch.float32))
    B, D = q.shape[0], q.shape[-1]
    K = q.shape[1] if folded else 1
    L, _, S, _ = kq.shape
    _build.require(q.dim() in (2, 3) and kq.shape == (L, B, S, D)
                   and vq.shape == kq.shape
                   and ks.shape == (L, B, n_heads, S) and vs.shape == ks.shape,
                   f"{name}: want q [B, D] or [B, K, D], kq/vq [L, B, S_pad, D], "
                   f"ks/vs [L, B, H, S_pad]")
    _build.require(D == n_heads * KERNEL_HEAD_DIM,
                   f"{name}: the kernel takes head_dim {KERNEL_HEAD_DIM}, "
                   f"got D={D} with {n_heads} heads")
    _build.require(S % KERNEL_ROW_GROUPS == 0,
                   f"{name}: S_pad={S} must be a multiple of "
                   f"{KERNEL_ROW_GROUPS}")
    _build.require(0 <= layer < L, f"{name}: layer {layer} not in [0, {L})")
    if folded:
        _build.require(K in KERNEL_BEAM_WIDTHS,
                       f"{name}: the kernel takes beam widths "
                       f"{KERNEL_BEAM_WIDTHS.start}..{KERNEL_BEAM_WIDTHS.stop - 1}, "
                       f"got {K}")
        smem = beam_shared_bytes(K, S)
        _build.require(smem <= MAX_SHARED_BYTES,
                       f"{name}: K={K} x S_pad={S} needs {smem} bytes of shared "
                       f"memory, more than a block has ({MAX_SHARED_BYTES})")
    out = torch.empty_like(q)
    lib = _build.load()
    args = (q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
            vs.data_ptr(), out.data_ptr(), L, B)
    tail = (S, D, n_heads, layer, q.device.index, _build.stream_of(q))
    if folded:
        _build.check(lib.sar_cross_decode_exact_beam(*args, K, *tail), name)
        BEAM_LAUNCHES += 1
    else:
        _build.check(lib.sar_cross_decode_exact(*args, *tail), name)
        LAUNCHES += 1
    return out


def beam_shared_bytes(K: int, S: int) -> int:
    """K5's dynamic shared memory: K rows of S_pad fp32 scores, which the
    final cross-warp reduction ([8 warps][K][64] floats) reuses."""
    return 4 * K * max(S, 8 * KERNEL_HEAD_DIM)
