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
the hand-written kernel (csrc/decode_cross.cu, csrc/decode_s8.cu) or
raise. The kernels take head_dim 64 and S_pad a multiple of 64, beam
widths 2..8 (K7 also 1), and write bf16; the layer is an offset into the
stacked cache (nothing is sliced or copied per step). K3 and K5 are one
kernel (`cross_decode_exact_kernel<K>`, K = 1 for K3) that splits S_pad
over a thread-block cluster of `cluster_split(S_pad)` blocks per (head,
sample); at large batch (`stream_heads`) K3 takes its large-batch form
instead (`cross_decode_exact_kernel_stream`: a block per SM streaming
items of one sample and STREAM_HEADS heads, no cluster). K7 shares its
kernel body with K9 (`s8_decode_kernel<K, mask>`) and splits S_pad over
`s8_cluster_split(S_pad)` blocks.
"""

from __future__ import annotations

import torch

from sar_tpu_torch.ops import _build

NEG = -1e30
KERNEL_HEAD_DIM = 64
KERNEL_ROW_GROUPS = 64
KERNEL_BEAM_WIDTHS = range(2, 9)      # K5's template instances (K3 is K = 1)
# K3/K5's split of S_pad and its shared memory (csrc/decode_cross.cu):
# clusters of at most MAX_CLUSTER blocks (the portable size), slices of at
# least MIN_SLICE rows where S_pad allows, v through a ring of at most
# RING_STAGES stages of RING_ROWS int8 rows of 64.
MAX_CLUSTER = 8
MIN_SLICE = 256
RING_ROWS = 64
RING_STAGES = 8
# A block's shared memory on the H100 (232,448 bytes) less 48 KB kept for
# the kernel's static arrays.
MAX_SHARED_BYTES = 232_448 - 48 * 1024

# K3's large-batch form (csrc/decode_cross.cu): one block per SM walks over
# items of one sample and STREAM_HEADS heads, streaming the item's
# contiguous k rows, then its v rows, in tiles of STREAM_ROWS rows through
# a ring of STREAM_STAGES stages that a producer warp fills for
# STREAM_WARPS consumer warps. K3 takes it where the (head, sample) pairs
# fill the card STREAM_PAIRS_PER_SM times over (`stream_heads`).
STREAM_HEADS = 4
STREAM_ROWS = 64
STREAM_STAGES = 8
STREAM_WARPS = 8
STREAM_PAIRS_PER_SM = 2
MAX_STREAM_SHARED_BYTES = 232_448
H100_SMS = 132

S8_BEAM_WIDTHS = range(1, 9)          # K7's template instances
LAUNCHES = 0          # K3 launches by cross_decode_attention_exact (CUDA, q [B, D])
STREAM_LAUNCHES = 0   # those of them in the large-batch form
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
    global LAUNCHES, BEAM_LAUNCHES, STREAM_LAUNCHES
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
                   f"memory per block (v ring, scores and v scales of a "
                   f"{cluster_split(S)[1]}-row slice), more than the "
                   f"{MAX_SHARED_BYTES} a block may have")
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
        STREAM_LAUNCHES += int(stream_heads(B, n_heads, S, _build.sm_count(q.device)) > 0)
    return out


def cross_decode_exact_form(q, kq, ks, vq, vs, *, layer: int, n_heads: int,
                            form: int) -> torch.Tensor:
    """K3 (q [B, D] on CUDA) in the form asked for, whatever the shape: 0
    the cluster form, 1 the large-batch form. For timing both forms at one
    shape and for the tests; it counts no launch, and no path calls it."""
    name = "cross_decode_exact_form"
    _build.require(q.device.type == "cuda" and q.dim() == 2,
                   f"{name}: want a CUDA query [B, D]")
    B, K, L, S, D = _check_slabs(name, q, dict(q=q, kq=kq, ks=ks, vq=vq, vs=vs),
                                 dict(q=torch.bfloat16), n_heads, layer)
    out = torch.empty_like(q)
    _build.check(_build.load().sar_cross_decode_exact_form(
        q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
        out.data_ptr(), L, B, S, D, n_heads, layer, form, q.device.index,
        _build.stream_of(q)), name)
    return out


def launched_form(B: int, n_heads: int, S: int, device) -> int:
    """The form the library launches for K3 at [B, n_heads, S_pad] on
    `device` (a CUDA device): `stream_heads` as the C source computes it."""
    return _build.load().sar_cross_decode_form(B, n_heads, S, torch.device(device).index or 0)


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


def cluster_split(S: int) -> tuple[int, int]:
    """(C, rows): K3/K5 run C = ceil(S_pad / MIN_SLICE) blocks per (head,
    sample), at most MAX_CLUSTER, in one cluster; block r owns rows
    [r * rows, min(S_pad, (r + 1) * rows)) with rows = ceil(S_pad / C)."""
    C = min(MAX_CLUSTER, -(-S // MIN_SLICE))
    return C, -(-S // C)


def stream_shared_bytes(S: int) -> int:
    """The large-batch form's dynamic shared memory per block: the ring
    (each stage STREAM_ROWS int8 rows of STREAM_HEADS heads, then their
    fp32 scales), the item's fp32 scores [STREAM_HEADS, S_pad], the
    warps' fp32 P.V partials [STREAM_WARPS, STREAM_HEADS * 64], their
    statistics (a float a warp, padded to 8 bytes) and an mbarrier pair a
    stage."""
    G, W, stages = STREAM_HEADS, STREAM_WARPS, STREAM_STAGES
    stage = G * (STREAM_ROWS * KERNEL_HEAD_DIM + STREAM_ROWS * 4)
    return (stages * stage + 4 * G * S + 4 * W * G * KERNEL_HEAD_DIM
            + 4 * (W + W % 2) + 16 * stages)


def stream_heads(B: int, H: int, S: int, sms: int = H100_SMS) -> int:
    """K3's form at [B, H, S_pad] on a card of `sms` SMs: STREAM_HEADS,
    the large-batch form's heads per item, where H divides into items of
    that many heads, the B * H (head, sample) pairs are at least
    STREAM_PAIRS_PER_SM per SM, and an item's scores fit beside the ring;
    else 0, the cluster form (`cluster_split`). K5 and K7 always take
    their clusters."""
    fits = stream_shared_bytes(S) <= MAX_STREAM_SHARED_BYTES
    take = H % STREAM_HEADS == 0 and B * H >= STREAM_PAIRS_PER_SM * sms and fits
    return STREAM_HEADS if take else 0


def stream_items(B: int, H: int, sms: int = H100_SMS) -> list[list[tuple[int, range]]]:
    """The large-batch form's work: min(items, sms) blocks, block k taking
    items k, k + blocks, ...; item i is sample i // (H / G) with heads
    G * (i % (H / G)) .. + G. -> per block, its (sample, heads) in order."""
    G = STREAM_HEADS
    items = B * (H // G)
    blocks = min(items, sms)
    return [[(i // (H // G), range(G * (i % (H // G)), G * (i % (H // G)) + G))
             for i in range(k, items, blocks)] for k in range(blocks)]


def beam_shared_bytes(K: int, S: int) -> int:
    """K3/K5's dynamic shared memory per block (K = 1 for K3): the int8 v
    ring (the whole slice when it has at most RING_STAGES * RING_ROWS
    rows, else RING_STAGES stages that it streams through), then K rows of
    the slice's fp32 scores and its fp32 v scales."""
    rows = cluster_split(S)[1]
    stages = min(RING_STAGES, -(-rows // RING_ROWS))
    return stages * RING_ROWS * KERNEL_HEAD_DIM + 4 * (K + 1) * rows


# K7/K9's split and shared memory (csrc/decode_s8.cu): clusters of at most
# MAX_CLUSTER blocks, slices of at least S8_MIN_SLICE rows where S_pad
# allows (K9 has its own minimum, ops/attic/decode_self.py), v through a
# ring of stages of S8_STAGE_ROWS int8 rows of 64 that holds at most
# S8_RING_ROWS rows, and the s8 probabilities in rows of whole
# S8_KSTEP-row product steps plus 16 bytes.
S8_MIN_SLICE = 512
S8_THREADS = 256
S8_KSTEP = 32
S8_STAGE_ROWS = S8_THREADS // 32 * S8_KSTEP // 2
S8_RING_ROWS = 512


def s8_cluster_split(S: int, min_slice: int = S8_MIN_SLICE) -> tuple[int, int]:
    """(C, rows): K7 (and K9, with its own `min_slice`) run C =
    ceil(S / min_slice) blocks per (head, sample), at most MAX_CLUSTER, in
    one cluster; block r owns rows [r * rows, min(S, (r + 1) * rows)) with
    rows = ceil(S / C)."""
    C = min(MAX_CLUSTER, -(-S // min_slice))
    return C, -(-S // C)


def s8_shared_bytes(K: int, S: int, min_slice: int = S8_MIN_SLICE) -> int:
    """K7/K9's dynamic shared memory per block: the int8 v ring (the whole
    slice when it has at most S8_RING_ROWS rows, else that many rows that
    it streams through), K rows of the slice's fp32
    scores and its fp32 v scales, K rows of s8 probabilities, then the C
    blocks' int32 [K][64] P.V partials."""
    C, rows = s8_cluster_split(S, min_slice)
    ring = min(S8_RING_ROWS, -(-rows // S8_STAGE_ROWS) * S8_STAGE_ROWS)
    pq_stride = -(-rows // S8_KSTEP) * S8_KSTEP + 16
    return (ring * KERNEL_HEAD_DIM + 4 * (K + 1) * rows + K * pq_stride
            + 4 * C * K * KERNEL_HEAD_DIM)


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
    _build.require(smem <= MAX_SHARED_BYTES,
                   f"{name}: K={K} x S_pad={S} needs {smem} bytes of shared "
                   f"memory per block (v ring, scores, v scales and s8 "
                   f"probabilities of a {s8_cluster_split(S)[1]}-row slice), "
                   f"more than the {MAX_SHARED_BYTES} a block may have")
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


def s8_decode_probe(qq, qs, kq, ks, vq, vs, *, layer: int, n_heads: int,
                    valid_len=None) -> tuple[torch.Tensor, ...]:
    """K7 (valid_len None; qq [B, D] or [B, K, D]) or K9 (a valid_len; qq
    [B, D]) on CUDA tensors, launched through the kernel's probe entry
    point, which also writes what the re-quantization saw: -> (out as
    the wrapper returns it, pw [B, K, H, S] fp32 (0 past valid_len), pq
    [B, K, H, S] s8, ps [B, K, H] fp32). The tests hold ps and pq to the
    kernel's own pw with this; it counts no launch, and no path calls it."""
    name = "s8_decode_probe"
    _build.require(qq.device.type == "cuda",
                   f"{name}: the probe launches the kernel, on a CUDA tensor only")
    folded = qq.dim() == 3
    B, D = qq.shape[0], qq.shape[-1]
    K = qq.shape[1] if folded else 1
    L, _, S, _ = kq.shape
    H = n_heads
    mask = valid_len is not None
    _build.require(not (mask and folded), f"{name}: K9 takes one query per sample")
    n_ptr, n_host = (_build.valid_len_arg(name, valid_len, qq.device, S)
                     if mask else (None, 0))
    out = torch.empty(qq.shape, dtype=torch.bfloat16, device=qq.device)
    pw = torch.zeros((B, K, H, S), dtype=torch.float32, device=qq.device)
    pq = torch.zeros((B, K, H, S), dtype=torch.int8, device=qq.device)
    ps = torch.zeros((B, K, H), dtype=torch.float32, device=qq.device)
    args = [t.contiguous() for t in (qq, qs, kq, ks, vq, vs)]
    _build.check(_build.load().sar_s8_decode_probe(
        *(t.data_ptr() for t in args), n_ptr, n_host, out.data_ptr(),
        pw.data_ptr(), ps.data_ptr(), pq.data_ptr(), L, B, K, S, D, H, layer,
        int(mask), qq.device.index, _build.stream_of(qq)), name)
    return out, pw, pq, ps
