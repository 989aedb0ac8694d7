"""LayerNorm of bf16 rows with fp32 parameters (kernel K13) and its plain
PyTorch version, `layer_norm_reference`: the kernel serves the
E-Branchformer blocks' LayerNorms (models/ebranchformer.py); every
LayerNorm of the Whisper model (`whisper.layer_norm`) is the plain version.

`layer_norm` dispatches on the tensors' device: CPU tensors take
`layer_norm_reference`; CUDA tensors launch the hand-written kernel
(csrc/layer_norm.cu) or raise. The kernel takes x bf16 [B, T, D] whose
channels are contiguous and whose rows lie evenly within each batch row
(a slice of a wider activation, or the first frames of a padded one, is
read in place), D a multiple of 256 with D / 256 in `KERNEL_CHUNKS`, fp32
scale and bias [D], and returns a contiguous [B, T, D] bf16: fp32 sums,
two passes over the row in registers, one rounding.
"""

from __future__ import annotations

import torch

from sar_tpu_torch.ops import _build

KERNEL_CHUNKS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16)   # D / 256 the kernel is built for
LAUNCHES = 0          # K13 launches by layer_norm (CUDA tensors only)


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """Plain version: LayerNorm over the last axis of x, in fp32, returned
    in x's dtype."""
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of x [B, T, D] with fp32 `scale` and
    `bias` [D], in fp32, returned in x's dtype. CUDA tensors launch K13."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps)
    global LAUNCHES
    name = "layer_norm"
    _build.require(x.dim() == 3, f"{name}: want x [B, T, D], got {tuple(x.shape)}")
    B, T, D = x.shape
    _build.require(D % 256 == 0 and D // 256 in KERNEL_CHUNKS,
                   f"{name}: the kernel takes D = 256 * {KERNEL_CHUNKS}, got {D}")
    _build.require(x.dtype == torch.bfloat16 and x.stride(2) == 1
                   and x.stride(1) % 8 == 0 and x.stride(0) % 8 == 0
                   and x.data_ptr() % 16 == 0,
                   f"{name}: want bf16 x with contiguous channels, rows 16-byte "
                   f"aligned, got {x.dtype} of strides {x.stride()}")
    _build.require(all(t.dtype == torch.float32 and t.is_contiguous() and t.shape == (D,)
                       and t.device == x.device for t in (scale, bias)),
                   f"{name}: want fp32 scale and bias [{D}] on {x.device}")
    y = torch.empty((B, T, D), dtype=torch.bfloat16, device=x.device)
    _build.check(_build.load().sar_layer_norm_rows(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), B, T, D,
        x.stride(0), x.stride(1), float(eps), x.device.index, _build.stream_of(x)), name)
    LAUNCHES += 1
    return y
