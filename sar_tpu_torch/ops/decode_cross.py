"""Cross-attention decode step over the int8 head-minor cache (kernels K3,
K5 and K7) and their plain PyTorch versions.

Exact (K3/K5), the counterpart of
sar_tpu/ops/decode_cross.py::cross_decode_attention_exact: scores =
(q.k)*ks over layer `layer`'s slab of the FULL stacked cache, masked where
ks <= 0 (layout padding), fp32 softmax, pw = (p*vs) in q's dtype, out =
sum pw*v with fp32 accumulation. q and the probabilities are never
quantized. q is [B, D] (greedy, K3) or beam-folded [B, K, D] (beam search,
K5): the K beam queries of a sample share its one slab, so the slab is
read once per step for all K beams.

s8 scores (K7, the `scores_int8` opt-in), the counterpart of
sar_tpu/ops/decode_cross.py::cross_decode_attention: the query arrives
quantized per (row, head) (qq s8, qs fp32), scores = (qq.kq)*qs*ks with an
exact integer dot, the same mask and fp32 softmax, then pw = p*vs is
re-quantized per (row, head) to s8 (ps = max|pw|/127, round half to even)
and out = (pq.vq)*ps with an exact integer sum. Same cache, layer offset
and beam folding as K3/K5 (qq [B, D] or [B, K, D], qs [B, H, 1] or
[B, K*H, 1] with row k*H + h).

`cross_decode_attention_exact` and `cross_decode_attention` dispatch on the
tensors' device: CPU tensors take the plain version; CUDA tensors launch
the hand-written kernel (csrc/decode_cross.cu, csrc/decode_cross_s8.cu) or
raise. The kernels take head_dim 64 and S_pad a multiple of 64, beam
widths 2..8 (K7 also 1), and write bf16; the layer is an offset into the
stacked cache (nothing is sliced or copied per step).
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

S8_BEAM_WIDTHS = range(1, 9)          # K7's template instances
LAUNCHES = 0          # K3 launches by cross_decode_attention_exact (CUDA, q [B, D])
BEAM_LAUNCHES = 0     # K5 launches (CUDA, beam-folded q [B, K, D])
S8_LAUNCHES = 0       # K7 launches by cross_decode_attention (CUDA, qq [B, D])
S8_BEAM_LAUNCHES = 0  # K7 launches (CUDA, beam-folded qq [B, K, D])


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
    tensors = dict(q=q, kq=kq, ks=ks, vq=vq, vs=vs)
    B, K, L, S, D = _check_slabs(name, q, tensors, dict(q=torch.bfloat16),
                                 n_heads, layer)
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


def _check_slabs(name: str, q: torch.Tensor, tensors: dict, q_dtypes: dict,
                 n_heads: int, layer: int) -> tuple[int, int, int, int, int]:
    """The checks K3, K5 and K7 share: one CUDA device, contiguous, aligned,
    the dtypes (`q_dtypes` for the query side), q [B, D] or [B, K, D]
    against kq/vq [L, B, S_pad, D] and ks/vs [L, B, H, S_pad], head_dim 64,
    S_pad a multiple of 64 and `layer` in range. Returns (B, K, L, S, D)."""
    kq, ks = tensors["kq"], tensors["ks"]
    _build.require(q.device.type == "cuda",
                   f"{name}: no kernel for device {q.device}")
    _build.require_cuda_args(
        name, tensors, dict(q_dtypes, kq=torch.int8, ks=torch.float32,
                            vq=torch.int8, vs=torch.float32))
    _build.require(q.dim() in (2, 3) and kq.dim() == 4,
                   f"{name}: want a query [B, D] or [B, K, D] and kq/vq "
                   f"[L, B, S_pad, D]")
    B, D = q.shape[0], q.shape[-1]
    K = q.shape[1] if q.dim() == 3 else 1
    L, _, S, _ = kq.shape
    _build.require(kq.shape == (L, B, S, D) and tensors["vq"].shape == kq.shape
                   and ks.shape == (L, B, n_heads, S)
                   and tensors["vs"].shape == ks.shape,
                   f"{name}: want q [B, D] or [B, K, D], kq/vq [L, B, S_pad, D], "
                   f"ks/vs [L, B, H, S_pad]")
    _build.require(D == n_heads * KERNEL_HEAD_DIM,
                   f"{name}: the kernel takes head_dim {KERNEL_HEAD_DIM}, "
                   f"got D={D} with {n_heads} heads")
    _build.require(S % KERNEL_ROW_GROUPS == 0,
                   f"{name}: S_pad={S} must be a multiple of "
                   f"{KERNEL_ROW_GROUPS}")
    _build.require(0 <= layer < L, f"{name}: layer {layer} not in [0, {L})")
    return B, K, L, S, D


def beam_shared_bytes(K: int, S: int) -> int:
    """K5's dynamic shared memory: K rows of S_pad fp32 scores, which the
    final cross-warp reduction ([8 warps][K][64] floats) reuses."""
    return 4 * K * max(S, 8 * KERNEL_HEAD_DIM)


# K7: one H100 block's shared memory less its static scratch (32 + 8 floats).
S8_MAX_SHARED_BYTES = 232_448 - 256


def s8_shared_bytes(K: int, S: int) -> int:
    """K7's dynamic shared memory: K rows of S_pad fp32 scores (reused by
    the cross-warp int32 reduction, [8 warps][K][64]) and K rows of S_pad
    s8 re-quantized probabilities."""
    return 4 * K * max(S, 8 * KERNEL_HEAD_DIM) + K * S


def int_einsum(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum of integer-valued operands summed exactly (float64 holds
    every partial sum: a P.V row reaches 1536 x 127 x 127, above fp32's
    2^24) and rounded once to fp32, as the int32 -> fp32 cast of an s8 x s8
    -> s32 product does."""
    return torch.einsum(equation, a.double(), b.double()).float()


def cross_decode_reference(qq, qs, kq, ks, vq, vs, *, layer: int,
                           n_heads: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """K7's plain version: qq [B, D] s8 with qs [B, H, 1], or beam-folded
    qq [B, K, D] with qs [B, K*H, 1] (row k*H + h); kq/vq [L, B, S_pad, D]
    s8; ks/vs [L, B, H, S_pad] fp32 -> qq's shape in `out_dtype`."""
    kq, ks, vq, vs = kq[layer], ks[layer], vq[layer], vs[layer]
    H = n_heads
    folded = qq.dim() == 3
    qf = qq if folded else qq[:, None]
    B, K, D = qf.shape
    hd = D // H
    S = kq.shape[1]
    qsf = qs.reshape(B, K, H, 1)
    st = int_einsum("bkhd,bshd->bkhs", qf.reshape(B, K, H, hd),
                  kq.reshape(B, S, H, hd)) * qsf * ks[:, None]
    st = torch.where(ks[:, None] > 0, st, NEG)
    p = torch.softmax(st, dim=-1)
    pw = p * vs[:, None]
    ps = pw.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
    pq = torch.clamp(torch.round(pw / ps), -127, 127)
    o = int_einsum("bkhs,bshd->bkhd", pq, vq.reshape(B, S, H, hd)) * ps
    o = o.reshape(B, K, D).to(out_dtype)
    return o if folded else o[:, 0]


def cross_decode_attention(qq, qs, kq, ks, vq, vs, *, layer: int,
                           n_heads: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """One s8-scores decode step of cross-attention for a batch: qq [B, D]
    or beam-folded [B, K, D] s8 (the pre-scaled query quantized per (row,
    head)) with qs [B, H, 1] or [B, K*H, 1] fp32, over layer `layer` of the
    full stacked cache -> qq's shape in `out_dtype`. CUDA tensors launch
    K7 (bf16 output only); CPU tensors take `cross_decode_reference`."""
    if qq.device.type == "cpu":
        return cross_decode_reference(qq, qs, kq, ks, vq, vs, layer=layer,
                                      n_heads=n_heads, out_dtype=out_dtype)
    global S8_LAUNCHES, S8_BEAM_LAUNCHES
    folded = qq.dim() == 3
    name = ("cross_decode_attention (s8, beam-folded, K7)" if folded
            else "cross_decode_attention (s8, K7)")
    tensors = dict(qq=qq, qs=qs, kq=kq, ks=ks, vq=vq, vs=vs)
    B, K, L, S, D = _check_slabs(name, qq, tensors,
                                 dict(qq=torch.int8, qs=torch.float32),
                                 n_heads, layer)
    _build.require(qs.shape == (B, K * n_heads, 1),
                   f"{name}: want qs [B, K*H, 1] = {(B, K * n_heads, 1)}, "
                   f"got {tuple(qs.shape)}")
    _build.require(out_dtype == torch.bfloat16,
                   f"{name}: the kernel writes bfloat16, not {out_dtype}")
    _build.require(K in S8_BEAM_WIDTHS,
                   f"{name}: the kernel takes beam widths "
                   f"{S8_BEAM_WIDTHS.start}..{S8_BEAM_WIDTHS.stop - 1}, got {K}")
    smem = s8_shared_bytes(K, S)
    _build.require(smem <= S8_MAX_SHARED_BYTES,
                   f"{name}: K={K} x S_pad={S} needs {smem} bytes of shared "
                   f"memory, more than a block has ({S8_MAX_SHARED_BYTES})")
    out = torch.empty(qq.shape, dtype=torch.bfloat16, device=qq.device)
    lib = _build.load()
    _build.check(lib.sar_cross_decode_s8(
        qq.data_ptr(), qs.data_ptr(), kq.data_ptr(), ks.data_ptr(),
        vq.data_ptr(), vs.data_ptr(), out.data_ptr(), L, B, K, S, D, n_heads,
        layer, qq.device.index, _build.stream_of(qq)), name)
    if folded:
        S8_BEAM_LAUNCHES += 1
    else:
        S8_LAUNCHES += 1
    return out
