"""Head-minor encoder attention (kernel K1) and its plain PyTorch version.

Counterpart of sar_tpu/ops/flash_enc.py::encoder_attention_hm: non-causal
multi-head attention read straight from the residual-stream layout
q/k/v [B, T_pad, H*hd] (q pre-scaled), key columns >= t_valid masked,
softmax in fp32 normalised after the PV product, output in q's dtype and
layout. Query rows >= t_valid are garbage that the caller slices off.

`encoder_attention_hm` dispatches on the tensors' device: CPU tensors take
`encoder_attention_hm_reference`; CUDA tensors launch the hand-written
kernel (csrc/flash_enc.cu) or raise. The kernel takes bf16, head_dim 64 and
T_pad a multiple of 64.
"""

from __future__ import annotations

import torch

from sar_tpu_torch.ops import _build

NEG = -1e30
KERNEL_HEAD_DIM = 64
KERNEL_ROW_TILE = 64

LAUNCHES = 0  # kernel launches by encoder_attention_hm (CUDA tensors only)


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
