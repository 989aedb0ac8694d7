"""Fused cross-KV projection + int8 quantization (kernel K2) and its plain
PyTorch version.

Counterpart of sar_tpu/ops/kv_init.py::fused_kv_init without LoRA: for
every decoder layer, K = x.Wk and V = x.Wv + bv with fp32 accumulation,
rounded to the compute dtype, then symmetric int8 per (row, head) with
scale = max(max|y|, 1e-8)/127; rows >= t_valid are 0 with scale 0. The
outputs are the head-minor DecodeCache cross fields.

`fused_kv_init` dispatches on the tensors' device: CPU tensors take
`fused_kv_init_reference`; CUDA tensors launch the hand-written kernel
(csrc/kv_init.cu) or raise. The kernel takes bf16, head_dim 64, S_pad a
multiple of 64 and d_model a multiple of 32.
"""

from __future__ import annotations

import torch

from sar_tpu_torch.ops import _build

KERNEL_HEAD_DIM = 64
KERNEL_ROW_TILE = 64

LAUNCHES = 0  # kernel launches by fused_kv_init (CUDA tensors only)


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
                            n_heads: int, t_valid: int):
    """Plain version: per layer, fp32 products (+ fp32 bias on V) rounded to
    enc_pad's dtype, then `quantize_rows` — the TPU kernel's quantization
    points."""
    B, S, D = enc_pad.shape
    L = wk.shape[0]
    dtype = enc_pad.dtype
    x32 = enc_pad.float()
    kq = torch.empty((L, B, S, D), dtype=torch.int8, device=enc_pad.device)
    vq = torch.empty_like(kq)
    ks = torch.empty((L, B, n_heads, S), dtype=torch.float32,
                     device=enc_pad.device)
    vs = torch.empty_like(ks)
    for l in range(L):
        k32 = x32 @ wk[l].float()
        v32 = x32 @ wv[l].float() + bv[l].float()
        kq[l], ks[l] = quantize_rows(k32.to(dtype), n_heads, t_valid)
        vq[l], vs[l] = quantize_rows(v32.to(dtype), n_heads, t_valid)
    return kq, ks, vq, vs


def fused_kv_init(enc_pad: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                  bv: torch.Tensor, *, n_heads: int, t_valid: int):
    """enc_pad [B, S_pad, D], wk/wv [L, D, D], bv [L, D] -> (kq [L, B, S_pad,
    D] s8, ks [L, B, H, S_pad] f32, vq, vs)."""
    if enc_pad.device.type == "cpu":
        return fused_kv_init_reference(enc_pad, wk, wv, bv, n_heads=n_heads,
                                       t_valid=t_valid)
    global LAUNCHES
    name = "fused_kv_init"
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
    dev = enc_pad.device
    kq = torch.empty((L, B, S, D), dtype=torch.int8, device=dev)
    vq = torch.empty_like(kq)
    ks = torch.empty((L, B, n_heads, S), dtype=torch.float32, device=dev)
    vs = torch.empty_like(ks)
    lib = _build.load()
    _build.check(lib.sar_fused_kv_init(
        enc_pad.data_ptr(), wk.data_ptr(), wv.data_ptr(), bv.data_ptr(),
        kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
        L, B, S, D, n_heads, t_valid, dev.index, _build.stream_of(enc_pad)),
        name)
    LAUNCHES += 1
    return kq, ks, vq, vs
