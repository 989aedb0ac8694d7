"""Flash-decode attention of one query row (kernel K10) and its plain
PyTorch version.

Counterpart of sar_tpu/ops/attic/attention.py::decode_attention, a parked
experiment of the JAX package with no caller there, and none here: q
[B, H, hd] (pre-scaled) against k/v [B, H, S, hd] -> [B, H, hd]. fp32
scores, positions >= valid_len masked when `valid_len` is given (a Python
int or a 0-d int32 tensor on the tensors' device), an fp32 softmax
NORMALISED and then cast to v's dtype, P.V accumulated in fp32, the output
in q's dtype (the TPU kernel's `_attend`).

`decode_attention` dispatches on the tensors' device: CPU tensors take
`decode_attention_reference`; CUDA tensors launch the hand-written kernel
(csrc/decode_attention.cu) or raise. The kernel takes bf16 and head_dim 64.
"""

from __future__ import annotations

import torch

from sar_tpu_torch.ops import _build

NEG = -1e30
KERNEL_HEAD_DIM = 64
MAX_SHARED_BYTES = 232_448 - 128

LAUNCHES = 0  # K10 launches by decode_attention (CUDA tensors only)


def decode_attention_reference(q, k, v, valid_len=None) -> torch.Tensor:
    """K10's plain version: q [B, H, hd], k/v [B, H, S, hd] -> [B, H, hd]
    in q's dtype."""
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k.float())
    if valid_len is not None:
        valid = torch.as_tensor(valid_len, device=s.device)
        s = torch.where(torch.arange(k.shape[2], device=s.device) < valid, s, NEG)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhs,bhsd->bhd", w.float(), v.float()).to(q.dtype)


def shared_bytes(S: int) -> int:
    """K10's dynamic shared memory: S fp32 scores, reused by the cross-warp
    reduction ([8 warps][64] floats)."""
    return 4 * max(S, 8 * KERNEL_HEAD_DIM)


def decode_attention(q, k, v, valid_len=None) -> torch.Tensor:
    """Single-token attention q [B, H, hd] x k/v [B, H, S, hd] ->
    [B, H, hd]; `valid_len` None attends to all S positions. CUDA tensors
    launch K10; CPU tensors take `decode_attention_reference`."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, valid_len)
    global LAUNCHES
    name = "decode_attention (K10)"
    _build.require(q.device.type == "cuda",
                   f"{name}: no kernel for device {q.device}")
    bf16 = torch.bfloat16
    _build.require_cuda_args(name, dict(q=q, k=k, v=v),
                             dict(q=bf16, k=bf16, v=bf16))
    _build.require(q.dim() == 3 and k.dim() == 4 and v.shape == k.shape,
                   f"{name}: want q [B, H, hd] and k/v [B, H, S, hd]")
    B, H, S, hd = k.shape
    _build.require(q.shape == (B, H, hd),
                   f"{name}: q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    _build.require(hd == KERNEL_HEAD_DIM,
                   f"{name}: the kernel takes head_dim {KERNEL_HEAD_DIM}, got {hd}")
    _build.require(shared_bytes(S) <= MAX_SHARED_BYTES,
                   f"{name}: S={S} needs {shared_bytes(S)} bytes of shared "
                   f"memory, more than a block has ({MAX_SHARED_BYTES})")
    n_ptr, n_host = ((None, S) if valid_len is None
                     else _build.valid_len_arg(name, valid_len, q.device, S))
    out = torch.empty_like(q)
    lib = _build.load()
    _build.check(lib.sar_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), n_ptr, n_host, out.data_ptr(),
        B, H, S, q.device.index, _build.stream_of(q)), name)
    LAUNCHES += 1
    return out
