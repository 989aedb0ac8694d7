"""Fused cross-KV projection + int8 quantization (kernels K2 and K4) and
their plain PyTorch version.

Counterpart of sar_tpu/ops/kv_init.py::fused_kv_init: for every decoder
layer, K = x.Wk and V = x.Wv + bv with fp32 accumulation, rounded to the
compute dtype, then symmetric int8 per (row, head) with
scale = max(max|y|, 1e-8)/127; rows >= t_valid are 0 with scale 0. The
outputs are the head-minor DecodeCache cross fields.

With `va` [L, B|1, D, r] / `vb` [L, B|1, r, D] (an adapter bank's cross_v
slices, one per sample or one for the whole batch) V carries the LoRA
term at the TPU kernel's (`_kernel_lora`) rounding points:

    u   = round_to_dtype(x @ va)          # fp32 sum
    V32 = (x @ Wv + bv) + lora_scale * (u @ vb)

and is rounded to the compute dtype once before the quantization.

`fused_kv_init` dispatches on the tensors' device: CPU tensors take
`fused_kv_init_reference`; CUDA tensors launch the hand-written kernel
(csrc/kv_init.cu: K2, or K4 with `va`/`vb`: the same tensor-core kernel
after a launch that sums u = x @ va into a scratch the wrapper allocates)
or raise. Both write into `out` (kq, ks, vq, vs) when it is given: the
slabs of a decode cache that its owner keeps (whisper.init_cache(out=)),
so that no second cross cache is allocated beside it. The kernels take bf16, head_dim 64 and S_pad a multiple of 64 (in
the configuration `kv_config` picks); K4 takes ranks up to 64 (the
wrapper zero-pads r to a multiple of 16, which leaves the delta
unchanged).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sar_tpu_torch.ops import _build

KERNEL_HEAD_DIM = 64
KERNEL_ROW_TILE = 64
KERNEL_RANK_GRANULE = 16
KERNEL_MAX_RANK = 64
# K2/K4's configurations (csrc/kv_init.cu, kKvConfigs), in order of
# preference: (rows per block, heads per block, ring stages); a block runs
# (rows / 32) * 2 * heads warps of 32 rows x one head's 64 columns of K or
# V. The first whose rows divide S_pad, whose heads divide the head count
# and whose shared memory fits a block on the H100 (MAX_SHARED_BYTES) is
# taken.
KV_CONFIGS = ((128, 1, 3), (64, 1, 3))
KV_K_SLICE = 32
MAX_SHARED_BYTES = 232_448

LAUNCHES = 0       # K2 launches by fused_kv_init (CUDA tensors only)
LORA_LAUNCHES = 0  # K4 launches by fused_kv_init with va/vb (CUDA only)


def kv_shared_bytes(config, rank: int = 0) -> int:
    """Dynamic shared memory of a K2/K4 projection block: a ring of stages
    of the x tile [rows][32 + 8] and the W slice [32][heads * 128 + 8], then
    (K4) vb [heads][rank][64 + 8] and u [rows][rank + 8], all bf16 (the +8
    pads put the 8 rows an ldmatrix phase reads in distinct banks)."""
    rows, heads, stages = config
    bk = KV_K_SLICE
    stage = rows * (bk + 8) + bk * (heads * 2 * KERNEL_HEAD_DIM + 8)
    lora = heads * rank * (KERNEL_HEAD_DIM + 8) + rows * (rank + 8) if rank else 0
    return 2 * (stages * stage + lora)


def kv_config(S_pad: int, n_heads: int, rank: int = 0):
    """The configuration K2 (rank 0) or K4 (the padded rank) takes for
    S_pad and n_heads, or None where none does."""
    for c in KV_CONFIGS:
        if (S_pad % c[0] == 0 and n_heads % c[1] == 0
                and kv_shared_bytes(c, rank) <= MAX_SHARED_BYTES):
            return c
    return None


def quantize_rows(y: torch.Tensor, n_heads: int, t_valid: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """y [B, S_pad, D] (already rounded to the compute dtype) -> int8 values
    [B, S_pad, D] and head-major scales [B, H, S_pad]; rows >= t_valid are
    0 with scale 0."""
    B, S, D = y.shape
    yf = y.float().reshape(B, S, n_heads, D // n_heads)
    scale = yf.abs().amax(-1).clamp_min(1e-8) / 127.0         # [B, S, H]
    q = torch.clamp(torch.round(yf / scale[..., None]), -127, 127)
    valid = (torch.arange(S, device=y.device) < t_valid)[None, :, None]
    q = torch.where(valid[..., None], q, 0.0).to(torch.int8)
    scale = torch.where(valid, scale, 0.0)
    return q.reshape(B, S, D), scale.transpose(1, 2).contiguous()


def fused_kv_init_reference(enc_pad: torch.Tensor, wk: torch.Tensor,
                            wv: torch.Tensor, bv: torch.Tensor, *,
                            n_heads: int, t_valid: int,
                            va: torch.Tensor | None = None,
                            vb: torch.Tensor | None = None,
                            lora_scale: float = 1.0, out=None):
    """Plain version: per layer, fp32 products (+ fp32 bias on V, + the
    fp32 LoRA term of the rounded u when `va`/`vb` are given) rounded to
    enc_pad's dtype, then `quantize_rows` — the TPU kernels' quantization
    points. Writes into `out` (kq, ks, vq, vs) when given."""
    B, S, D = enc_pad.shape
    L = wk.shape[0]
    dtype = enc_pad.dtype
    x32 = enc_pad.float()
    kq, ks, vq, vs = output_slabs("fused_kv_init_reference", out, L, B, S, D,
                                  n_heads, enc_pad.device)
    for l in range(L):
        k32 = x32 @ wk[l].float()
        v32 = x32 @ wv[l].float() + bv[l].float()
        if va is not None:                       # va[l] [B|1, D, r] broadcasts
            u = (x32 @ va[l].float()).to(dtype).float()
            v32 = v32 + lora_scale * (u @ vb[l].float())
        kq[l], ks[l] = quantize_rows(k32.to(dtype), n_heads, t_valid)
        vq[l], vs[l] = quantize_rows(v32.to(dtype), n_heads, t_valid)
    return kq, ks, vq, vs


def fused_kv_init(enc_pad: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                  bv: torch.Tensor, *, n_heads: int, t_valid: int,
                  va: torch.Tensor | None = None,
                  vb: torch.Tensor | None = None, lora_scale: float = 1.0,
                  out=None):
    """enc_pad [B, S_pad, D], wk/wv [L, D, D], bv [L, D] (+ optional va
    [L, B|1, D, r], vb [L, B|1, r, D]) -> (kq [L, B, S_pad, D] s8,
    ks [L, B, H, S_pad] f32, vq, vs), written into `out` when given."""
    if enc_pad.device.type == "cpu":
        return fused_kv_init_reference(enc_pad, wk, wv, bv, n_heads=n_heads,
                                       t_valid=t_valid, va=va, vb=vb,
                                       lora_scale=lora_scale, out=out)
    if (va is None) != (vb is None):
        raise ValueError("fused_kv_init: va and vb come together")
    global LAUNCHES, LORA_LAUNCHES
    name = "fused_kv_init" if va is None else "fused_kv_init_lora"
    _build.require(enc_pad.device.type == "cuda",
                   f"{name}: no kernel for device {enc_pad.device}")
    bf16 = torch.bfloat16
    _build.require_cuda_args(name, dict(x=enc_pad, wk=wk, wv=wv, bv=bv),
                             dict(x=bf16, wk=bf16, wv=bf16, bv=bf16))
    B, S, D = enc_pad.shape
    L = wk.shape[0]
    _build.require(enc_pad.dim() == 3 and wk.shape == (L, D, D)
                   and wv.shape == (L, D, D) and bv.shape == (L, D),
                   f"{name}: want x [B, S_pad, D], wk/wv [L, D, D], bv [L, D]")
    _build.require(D == n_heads * KERNEL_HEAD_DIM,
                   f"{name}: the kernel takes head_dim {KERNEL_HEAD_DIM}, "
                   f"got D={D} with {n_heads} heads")
    _build.require(S % KERNEL_ROW_TILE == 0 and 0 < t_valid <= S,
                   f"{name}: S_pad={S} must be a multiple of "
                   f"{KERNEL_ROW_TILE} and hold t_valid={t_valid}")
    r = 0
    if va is not None:
        va, vb, Bv, r = _lora_slices(name, va, vb, L, B, D)
    _build.require(kv_config(S, n_heads, r) is not None,
                   f"{name}: no kernel configuration takes S_pad={S} with "
                   f"{n_heads} heads and rank {r}")
    dev = enc_pad.device
    kq, ks, vq, vs = output_slabs(name, out, L, B, S, D, n_heads, dev)
    lib = _build.load()
    if va is None:
        _build.check(lib.sar_fused_kv_init(
            enc_pad.data_ptr(), wk.data_ptr(), wv.data_ptr(), bv.data_ptr(),
            kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
            L, B, S, D, n_heads, t_valid, dev.index, _build.stream_of(enc_pad)),
            name)
        LAUNCHES += 1
        return kq, ks, vq, vs
    _build.require_cuda_args(name, dict(x=enc_pad, va=va, vb=vb),
                             dict(x=torch.bfloat16, va=torch.bfloat16,
                                  vb=torch.bfloat16))
    # K4's first launch writes u = bf16(x @ va), once per (row, layer), here.
    u = torch.empty((L, B * S, r), dtype=torch.bfloat16, device=dev)
    _build.check(lib.sar_fused_kv_init_lora(
        enc_pad.data_ptr(), wk.data_ptr(), wv.data_ptr(), bv.data_ptr(),
        va.data_ptr(), vb.data_ptr(), u.data_ptr(),
        kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
        L, B, Bv, S, D, n_heads, r, t_valid, float(lora_scale), dev.index,
        _build.stream_of(enc_pad)), name)
    LORA_LAUNCHES += 1
    return kq, ks, vq, vs


def output_slabs(name, out, L, B, S, D, n_heads, device):
    """(kq, ks, vq, vs): `out` checked against the shapes, dtypes and
    device the kernels write (contiguous), or new tensors when it is None."""
    want = ((L, B, S, D), torch.int8), ((L, B, n_heads, S), torch.float32)
    if out is None:
        kq, ks = (torch.empty(shape, dtype=dt, device=device) for shape, dt in want)
        return kq, ks, torch.empty_like(kq), torch.empty_like(ks)
    _build.require(len(out) == 4, f"{name}: out is (kq, ks, vq, vs)")
    for t, (shape, dt) in zip(out, want + want):
        _build.require(tuple(t.shape) == shape and t.dtype == dt
                       and t.device == device and t.is_contiguous(),
                       f"{name}: out wants contiguous {shape} {dt} on {device}, "
                       f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    return tuple(out)


def _lora_slices(name, va, vb, L, B, D):
    """Check K4's LoRA operands and zero-pad the rank to the kernel's
    granule (zero rank columns of va and rows of vb add exactly 0)."""
    _build.require(va.dim() == 4 and vb.dim() == 4,
                   f"{name}: want va [L, B|1, D, r] and vb [L, B|1, r, D]")
    Bv, r = va.shape[1], va.shape[3]
    _build.require(va.shape == (L, Bv, D, r) and vb.shape == (L, Bv, r, D)
                   and Bv in (1, B),
                   f"{name}: want va [L, B|1, D, r] and vb [L, B|1, r, D] "
                   f"with L={L}, B={B}, D={D}; got {tuple(va.shape)} and "
                   f"{tuple(vb.shape)}")
    _build.require(1 <= r <= KERNEL_MAX_RANK,
                   f"{name}: the kernel takes ranks 1..{KERNEL_MAX_RANK}, got {r}")
    rp = -(-r // KERNEL_RANK_GRANULE) * KERNEL_RANK_GRANULE
    if rp != r:
        va = F.pad(va, (0, rp - r))
        vb = F.pad(vb, (0, 0, 0, rp - r))
    return va.contiguous(), vb.contiguous(), Bv, rp
