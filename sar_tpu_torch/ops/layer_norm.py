"""LayerNorm of bf16 rows with fp32 parameters (kernel K13), the residual
add and LayerNorm of a sublayer boundary (kernel K14), and their plain
PyTorch versions, `layer_norm_reference` and `add_layer_norm_reference`.
K13 serves the E-Branchformer blocks' LayerNorms (models/ebranchformer.py)
and the first LayerNorm of Whisper's decoder step; K14 the others of that
step (`whisper.decode_step`). Whisper's other LayerNorms
(`whisper.layer_norm`) are the plain version.

`layer_norm` dispatches on the tensors' device: CPU tensors take
`layer_norm_reference`; CUDA tensors launch the hand-written kernel
(csrc/layer_norm.cu) or raise. The kernel takes x bf16 [B, T, D] whose
channels are contiguous and whose rows lie evenly within each batch row
(a slice of a wider activation, or the first frames of a padded one, is
read in place), D a multiple of 256 with D / 256 in `KERNEL_CHUNKS`, fp32
scale and bias [D], and returns a contiguous [B, T, D] bf16: fp32 sums,
two passes over the row in registers, one rounding.

`add_layer_norm` dispatches the same way. K14 takes x and y bf16 [..., D]
contiguous and of one shape, an optional bf16 bias b [D], D as K13, fp32
scale and bias [D], and returns (x_new, h): x_new = x + (y + b) with each
add rounded to bf16 as PyTorch's bf16 adds round (bit-equal to the plain
version), h the LayerNorm of x_new as K13 computes it.
"""

from __future__ import annotations

import torch

from sar_tpu_torch.ops import _build

KERNEL_CHUNKS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16)   # D / 256 the kernel is built for
LAUNCHES = 0          # K13 launches by layer_norm (CUDA tensors only)
ADD_LAUNCHES = 0      # K14 launches by add_layer_norm (CUDA tensors only)


def kernel_takes(D: int) -> bool:
    """Whether K13 and K14 are built for rows of D values."""
    return D % 256 == 0 and D // 256 in KERNEL_CHUNKS


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
    _build.require(kernel_takes(D),
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


def add_layer_norm_reference(x: torch.Tensor, y: torch.Tensor, b: torch.Tensor | None,
                             scale: torch.Tensor, bias: torch.Tensor,
                             eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: x_new = x + (y + b) (x + y without b), each add in
    y's dtype as `whisper.linear` and the residual add run them, and
    h = layer_norm_reference(x_new). Returns (x_new, h)."""
    if b is not None:
        y = y + b.to(y.dtype)
    x = x + y
    return x, layer_norm_reference(x, scale, bias, eps)


def add_layer_norm(x: torch.Tensor, y: torch.Tensor, b: torch.Tensor | None,
                   scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add of a sublayer's output y (plus its bias b, if not
    None) to x [..., D], and the LayerNorm of the sum with fp32 `scale` and
    `bias` [D]: (x_new, h). CUDA tensors launch K14."""
    if x.device.type == "cpu":
        return add_layer_norm_reference(x, y, b, scale, bias, eps)
    global ADD_LAUNCHES
    name = "add_layer_norm"
    D = x.shape[-1]
    _build.require(kernel_takes(D),
                   f"{name}: the kernel takes D = 256 * {KERNEL_CHUNKS}, got {D}")
    _build.require(y.shape == x.shape, f"{name}: y {tuple(y.shape)} is not x's "
                   f"{tuple(x.shape)}")
    tensors = {"x": x, "y": y, "scale": scale, "bias": bias}
    dtypes = {"x": torch.bfloat16, "y": torch.bfloat16, "b": torch.bfloat16,
              "scale": torch.float32, "bias": torch.float32}
    if b is not None:
        tensors["b"] = b = b.to(torch.bfloat16)
    _build.require_cuda_args(name, tensors, dtypes)
    _build.require(all(t.shape == (D,) for k, t in tensors.items() if k not in ("x", "y")),
                   f"{name}: want b, scale and bias of [{D}]")
    x_new, h = torch.empty_like(x), torch.empty_like(x)
    _build.check(_build.load().sar_add_layer_norm_rows(
        x.data_ptr(), y.data_ptr(), None if b is None else b.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), x_new.data_ptr(), h.data_ptr(), x.numel() // D, D, float(eps),
        x.device.index, _build.stream_of(x)), name)
    ADD_LAUNCHES += 1
    return x_new, h
