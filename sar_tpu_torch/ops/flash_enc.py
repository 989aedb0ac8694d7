"""Encoder attention on the head-minor residual layout: K1 (attention) and
K8 (pre-LN + q/k/v projections + attention, fused), each with its plain
PyTorch version.

K1, the counterpart of sar_tpu/ops/flash_enc.py::encoder_attention_hm:
non-causal multi-head attention read straight from the residual-stream
layout q/k/v [B, T_pad, H*hd] (q pre-scaled), key columns >= t_valid
masked, softmax in fp32 normalised after the PV product, output in q's
dtype and layout. Query rows >= t_valid are garbage that the caller slices
off.

K8, the counterpart of sar_tpu/ops/flash_enc.py::encoder_attention_fused
(the `encode(flash="fq")` path): from the PRE-LN residual x [B, T_pad, D],
a LayerNorm with the one-pass variance mean(x^2) - mean(x)^2 (h rounded to
x's dtype), the projections q = (h.wq + bq) * hd^-0.5 (rounded once),
k = h.wk, v = h.wv + bv accumulated in fp32 and rounded to x's dtype, then
K1's attention. Zero pad rows give var = 0 and h = the LN bias: finite.

`encoder_attention_hm` and `encoder_attention_fused` dispatch on the
tensors' device: CPU tensors take the plain version; CUDA tensors launch
the hand-written kernels (csrc/flash_enc.cu) or raise. The kernels take
bf16, head_dim 64 and T_pad a multiple of 64 (K8 also D a multiple of 64,
fp32 LN params and bf16 weights and biases).
"""

from __future__ import annotations

import torch

from sar_tpu_torch.ops import _build

NEG = -1e30
KERNEL_HEAD_DIM = 64
KERNEL_ROW_TILE = 64

LAUNCHES = 0        # kernel launches by encoder_attention_hm (CUDA tensors only)
FUSED_LAUNCHES = 0  # K8 launches by encoder_attention_fused (CUDA tensors only)

# The JAX package's rule for which function `encode(flash="fq")` computes,
# copied verbatim (sar_tpu/ops/flash_enc.py): the TPU kernel's VMEM budget
# and lane constraints decide whether "fq" runs fused or falls back to "hm".
# It is not a limit of the H100; it is kept so that one shape takes the
# same route in both packages, since "fq" and "hm" round differently
# (whisper-small and -medium fused, whisper-large and unaligned T on "hm").
BLOCK_Q = 256
LN_EPS = 1e-5
FUSED_VMEM_BUDGET = 14 * 1024 * 1024


def _fused_vmem_bytes(T: int, D: int, bq: int) -> int:
    """Rough per-core VMEM footprint of the TPU kernel's resident set:
    double-buffered x block, LN scratch, K/V slabs, weight slices, and the
    per-head fp32 score block."""
    bf2, f4 = 2, 4
    return (2 * T * D * bf2            # x block (double-buffered)
            + T * D * bf2              # h_s
            + 2 * T * 128 * bf2        # k_s + v_s
            + 2 * 3 * D * 128 * bf2    # wq/wk/wv slices (double-buffered)
            + 2 * bq * T * f4          # score/prob temporaries
            + 2 * bq * 128 * bf2)      # out block


def _pick_bq(T: int, D: int) -> int | None:
    """Largest q-block (divisor of T, <= BLOCK_Q) whose resident set fits
    the VMEM budget — whisper-medium fits at bq=128 where 256 would not.
    Blocks under 128 rows (whisper-large would need bq=8) starve the MXU;
    those shapes keep the unfused hm path instead."""
    floor = min(128, T)
    for b in range(min(BLOCK_Q, T), floor - 1, -1):
        if T % b == 0 and _fused_vmem_bytes(T, D, b) <= FUSED_VMEM_BUDGET:
            return b
    return None


def fused_qkv_supported(T_padded: int, D: int, n_heads: int) -> bool:
    """Whether the fused LN+QKV+attention kernel fits this shape (VMEM
    budget + the head-group lane constraints shared with flash='hm')."""
    group = min(128, D)
    hd = D // n_heads
    if D % group or group % hd:
        return False
    if T_padded % 128:
        return False                    # chunked LN walks 128-row tiles
    return _pick_bq(T_padded, D) is not None


def encoder_attention_hm_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, *, n_heads: int,
                                   t_valid: int) -> torch.Tensor:
    """Plain version with the TPU kernel's quantization points: fp32 scores
    from q's dtype, masked keys, unnormalised exp cast to q's dtype for the
    PV product (fp32 accumulation), then scaled by 1/sum."""
    B, T, D = q.shape
    hd = D // n_heads
    dtype = q.dtype

    def heads(x):
        return x.reshape(B, T, n_heads, hd).transpose(1, 2).float()

    s = heads(q) @ heads(k).transpose(-1, -2)                 # [B, H, T, T]
    s = s.masked_fill(torch.arange(T, device=q.device) >= t_valid, NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    inv = 1.0 / p.sum(-1, keepdim=True)
    o = (p.to(dtype).float() @ heads(v)) * inv                 # [B, H, T, hd]
    return o.to(dtype).transpose(1, 2).reshape(B, T, D)


def encoder_attention_hm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, n_heads: int, t_valid: int) -> torch.Tensor:
    """q/k/v [B, T_pad, H*hd] head-minor (q pre-scaled) -> [B, T_pad, H*hd]."""
    if q.device.type == "cpu":
        return encoder_attention_hm_reference(q, k, v, n_heads=n_heads,
                                              t_valid=t_valid)
    global LAUNCHES
    name = "encoder_attention_hm"
    _build.require(q.device.type == "cuda",
                   f"{name}: no kernel for device {q.device}")
    _build.require_cuda_args(name, dict(q=q, k=k, v=v),
                             dict(q=torch.bfloat16, k=torch.bfloat16,
                                  v=torch.bfloat16))
    B, T, D = q.shape
    _build.require(q.dim() == 3 and k.shape == q.shape and v.shape == q.shape,
                   f"{name}: q/k/v must share one [B, T_pad, D] shape")
    _build.require(D == n_heads * KERNEL_HEAD_DIM,
                   f"{name}: the kernel takes head_dim {KERNEL_HEAD_DIM}, "
                   f"got D={D} with {n_heads} heads")
    _build.require(T % KERNEL_ROW_TILE == 0 and 0 < t_valid <= T,
                   f"{name}: T_pad={T} must be a multiple of "
                   f"{KERNEL_ROW_TILE} and hold t_valid={t_valid}")
    out = torch.empty_like(q)
    lib = _build.load()
    _build.check(lib.sar_encoder_attention_hm(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, D,
        n_heads, t_valid, q.device.index, _build.stream_of(q)), name)
    LAUNCHES += 1
    return out


def encoder_attention_fused_reference(x, ln_scale, ln_bias, wq, bq, wk, wv,
                                      bv, *, n_heads: int,
                                      t_valid: int) -> torch.Tensor:
    """K8's plain version with the TPU kernel's rounding points: the
    one-pass LayerNorm in fp32 rounded to x's dtype, the three projections
    summed in fp32 from x-dtype h (bias and, for q, the scaling applied
    before the one rounding to x's dtype), then K1's plain attention."""
    dtype = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mu * mu
    h = ((x32 - mu) * torch.rsqrt(var + LN_EPS) * ln_scale.float()
         + ln_bias.float()).to(dtype).float()
    scaling = (x.shape[-1] // n_heads) ** -0.5
    q = ((h @ wq.float() + bq.float()) * scaling).to(dtype)
    k = (h @ wk.float()).to(dtype)
    v = (h @ wv.float() + bv.float()).to(dtype)
    return encoder_attention_hm_reference(q, k, v, n_heads=n_heads,
                                          t_valid=t_valid)


def encoder_attention_fused(x, ln_scale, ln_bias, wq, bq, wk, wv, bv, *,
                            n_heads: int, t_valid: int) -> torch.Tensor:
    """Pre-LN x [B, T_pad, D] -> the attention output [B, T_pad, D]
    (head-minor, before the out-projection); ln_scale/ln_bias [D], wq/wk/wv
    [D, D] (in x out), bq/bv [D]. On CUDA: K8, one entry point that
    launches the LN + projection kernel into a [3, B, T_pad, D] scratch and
    K1's attention kernel over it."""
    if x.device.type == "cpu":
        return encoder_attention_fused_reference(
            x, ln_scale, ln_bias, wq, bq, wk, wv, bv, n_heads=n_heads,
            t_valid=t_valid)
    global FUSED_LAUNCHES
    name = "encoder_attention_fused (K8)"
    _build.require(x.device.type == "cuda",
                   f"{name}: no kernel for device {x.device}")
    bf16, f32 = torch.bfloat16, torch.float32
    _build.require_cuda_args(
        name, dict(x=x, ln_scale=ln_scale, ln_bias=ln_bias, wq=wq, bq=bq,
                   wk=wk, wv=wv, bv=bv),
        dict(x=bf16, ln_scale=f32, ln_bias=f32, wq=bf16, bq=bf16, wk=bf16,
             wv=bf16, bv=bf16))
    _build.require(x.dim() == 3, f"{name}: x must be [B, T_pad, D]")
    B, T, D = x.shape
    _build.require(all(w.shape == (D, D) for w in (wq, wk, wv))
                   and all(p.shape == (D,) for p in (ln_scale, ln_bias, bq, bv)),
                   f"{name}: want wq/wk/wv [D, D] and ln_scale/ln_bias/bq/bv "
                   f"[D] for D={D}")
    _build.require(D == n_heads * KERNEL_HEAD_DIM,
                   f"{name}: the kernel takes head_dim {KERNEL_HEAD_DIM}, "
                   f"got D={D} with {n_heads} heads")
    _build.require(T % KERNEL_ROW_TILE == 0 and 0 < t_valid <= T,
                   f"{name}: T_pad={T} must be a multiple of "
                   f"{KERNEL_ROW_TILE} and hold t_valid={t_valid}")
    qkv = torch.empty((3, B, T, D), dtype=bf16, device=x.device)
    out = torch.empty_like(x)
    lib = _build.load()
    _build.check(lib.sar_encoder_attention_fused(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), wq.data_ptr(),
        bq.data_ptr(), wk.data_ptr(), wv.data_ptr(), bv.data_ptr(),
        qkv.data_ptr(), out.data_ptr(), B, T, D, n_heads, t_valid,
        x.device.index, _build.stream_of(x)), name)
    FUSED_LAUNCHES += 1
    return out
