"""Depthwise convolution over time on the [B, T, C] layout (kernel K12),
with the zero padding of the valid frames, the bias and a gate or a
residual fused, and its plain PyTorch version: the two time convolutions
of an E-Branchformer block (models/ebranchformer.py).

    y[b, t, c] = bias[c] + sum_j w[c, j] * x[b, t + j - K // 2, c]
                 (x read as 0 outside [0, t_valid)),
    then y * gate (the cgMLP: r * conv(g)) or y + x (the merge:
    m + conv(m)), rounded once to x's dtype.

`depthwise_conv_time` dispatches on the tensors' device: CPU tensors take
`depthwise_conv_time_reference` (F.conv1d in fp32 over the masked input,
the epilogue in fp32, one rounding); CUDA tensors launch the hand-written
kernel (csrc/dwconv_time.cu) or raise. The kernel takes bf16 x, w, bias
and gate, an odd K <= 63, an even C, a contiguous x and w, and a gate
whose channels are contiguous and whose rows lie `stride(1)` apart (a
slice of a wider activation: the cgMLP's r half).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sar_tpu_torch.ops import _build

MAX_KERNEL = 63
LAUNCHES = 0          # K12 launches by depthwise_conv_time (CUDA tensors only)


def depthwise_conv_time_reference(x, w, bias, *, t_valid: int | None = None,
                                  gate=None, residual: bool = False) -> torch.Tensor:
    """Plain version: x [B, T, C], w [C, K] (or F.conv1d's [C, 1, K]), bias
    [C]; rows >= `t_valid` (default T) read as zero; fp32 throughout,
    rounded once to x's dtype."""
    B, T, C = x.shape
    K = w.shape[-1]
    xf = x.float()
    if t_valid is not None and t_valid < T:
        keep = (torch.arange(T, device=x.device) < t_valid)[None, :, None]
        xf = torch.where(keep, xf, 0.0)
    y = F.conv1d(xf.transpose(1, 2), w.reshape(C, 1, K).float(), bias.float(),
                 padding=K // 2, groups=C).transpose(1, 2)
    if gate is not None:
        y = y * gate.float()
    if residual:
        y = y + x.float()
    return y.to(x.dtype)


def depthwise_conv_time(x, w, bias, *, t_valid: int | None = None, gate=None,
                        residual: bool = False) -> torch.Tensor:
    """The depthwise time convolution of the module docstring: x [B, T, C],
    w [C, K] or [C, 1, K], bias [C], `gate` [B, T, C] (a view whose rows
    may be wider) or None, `residual` adds x. CUDA tensors launch K12."""
    if x.device.type == "cpu":
        return depthwise_conv_time_reference(x, w, bias, t_valid=t_valid, gate=gate,
                                             residual=residual)
    global LAUNCHES
    name = "depthwise_conv_time"
    _build.require(x.dim() == 3, f"{name}: want x [B, T, C], got {tuple(x.shape)}")
    B, T, C = x.shape
    K = w.shape[-1]
    w2 = w.reshape(C, K)
    t_valid = T if t_valid is None else int(t_valid)
    _build.require(w.numel() == C * K and bias.shape == (C,),
                   f"{name}: want w [C, K] and bias [C] for C = {C}")
    _build.require(K % 2 == 1 and K <= MAX_KERNEL,
                   f"{name}: the kernel takes an odd K <= {MAX_KERNEL}, got {K}")
    _build.require(C % 2 == 0, f"{name}: the kernel takes an even C, got {C}")
    _build.require(0 <= t_valid <= T, f"{name}: t_valid {t_valid} not in [0, {T}]")
    _build.require_cuda_args(name, dict(x=x, w=w2, bias=bias),
                             dict(x=torch.bfloat16, w=torch.bfloat16, bias=torch.bfloat16))
    gate_ptr, gate_stride = None, 0
    if gate is not None:
        _build.require(gate.shape == x.shape and gate.dtype == torch.bfloat16
                       and gate.device == x.device and gate.stride(2) == 1
                       and gate.stride(0) == T * gate.stride(1)
                       and gate.stride(1) % 2 == 0 and gate.data_ptr() % 4 == 0,
                       f"{name}: want a bf16 gate [B, T, C] on {x.device} with "
                       f"contiguous channels and rows an even stride apart")
        gate_ptr, gate_stride = gate.data_ptr(), gate.stride(1)
    y = torch.empty_like(x)
    _build.check(_build.load().sar_dwconv_time(
        x.data_ptr(), w2.data_ptr(), bias.data_ptr(), gate_ptr, y.data_ptr(), B, T, C, K,
        t_valid, gate_stride, int(residual), x.device.index, _build.stream_of(x)), name)
    LAUNCHES += 1
    return y
