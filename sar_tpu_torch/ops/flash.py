"""Blockwise multi-head attention for training (kernel K6) and its plain
PyTorch version.

Counterpart of sar_tpu/ops/flash.py::flash_mha: q [B, H, Tq, hd] (pre-scaled
by hd^-0.5, no further scaling) against k/v [B, H, Tk, hd] -> [B, H, Tq, hd],
fp32 scores, an optional causal mask on absolute positions, the
probabilities cast to q's dtype before the PV product; forward and
backward. The JAX package pads Tq/Tk to its 128-row tile with segment ids;
the kernels here take the valid lengths and mask ragged tiles themselves,
so the real rows equal the padded-and-segmented result and no pad row
exists.

`flash_mha` dispatches on the tensors' device: CPU tensors take
`flash_mha_reference` (autograd of it is the plain backward); CUDA tensors
go through the custom op `sar_tpu_torch::flash_attention`, whose forward is
the hand-written forward kernel (csrc/flash_attn.cu, it also writes the
fp32 row log-sum-exp) and whose autograd backward runs the dK/dV and dQ
kernels after di = rowsum(o * do) in plain torch (the JAX package computes
di outside its kernels too). Being a custom op, the forward is visible to
a selective-checkpoint policy, which saves its output so a recompute never
runs attention again (models/whisper.py::_remat). The kernels take bf16,
head_dim 64, and causal only with Tq == Tk; the wrappers raise on anything
else. Each of the three kernel wrappers (`flash_attention_fwd`,
`flash_attention_bwd_dkv`, `flash_attention_bwd_dq`) takes its own plain
version for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from sar_tpu_torch.ops import _build

KERNEL_HEAD_DIM = 64
_MASKED = torch.finfo(torch.float32).min

# Kernel launches (CUDA tensors only).
LAUNCHES = 0       # forward
DKV_LAUNCHES = 0   # backward dK/dV
DQ_LAUNCHES = 0    # backward dQ


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """fp32 q k^T, entries above the diagonal (absolute positions) masked."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        above = (torch.arange(Tk, device=s.device)[None, :]
                 > torch.arange(Tq, device=s.device)[:, None])
        s = s.masked_fill(above, _MASKED)
    return s


def flash_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False) -> torch.Tensor:
    """The plain version: fp32 scores and softmax, probabilities cast to q's
    dtype for the PV product (the JAX package's `attention`)."""
    probs = torch.softmax(_scores(q, k, causal), dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def flash_attention_fwd_reference(q, k, v, *, causal: bool = False):
    """Plain version of the forward kernel: (o [B, H, Tq, hd], lse [B, H, Tq]
    fp32)."""
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p.to(q.dtype), v), lse


def _probs_and_ds(q, k, v, do, lse, di, causal):
    """p = exp(s - lse) and ds = p * (do v^T - di), both fp32."""
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - di[..., None])


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, di, *,
                                      causal: bool = False):
    """Plain version of the dK/dV kernel: dv = bf16(p)^T do, dk = bf16(ds)^T q
    (fp32 sums), each rounded to k's dtype once."""
    p, ds = _probs_and_ds(q, k, v, do, lse, di, causal)
    dt = k.dtype
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(dt).float().transpose(-1, -2), q.float())
    return dk.to(dt), dv.to(dt)


def flash_attention_bwd_dq_reference(q, k, v, do, lse, di, *,
                                     causal: bool = False):
    """Plain version of the dQ kernel: dq = bf16(ds) k (fp32 sums)."""
    _, ds = _probs_and_ds(q, k, v, do, lse, di, causal)
    return torch.matmul(ds.to(q.dtype).float(), k.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _require_kernel_args(name: str, causal: bool, **tensors) -> None:
    """[B, H, T, 64] bf16 views on one CUDA device with a contiguous last
    dimension and 16-byte aligned rows (strides multiples of 8)."""
    devices = {t.device for t in tensors.values()}
    _build.require(len(devices) == 1 and next(iter(devices)).type == "cuda",
                   f"{name}: no kernel for devices {devices}")
    q, k = tensors["q"], tensors["k"]
    _build.require(q.dim() == 4 and k.dim() == 4,
                   f"{name}: q and k must be [B, H, T, hd]")
    B, H, Tq, hd = q.shape
    Tk = k.shape[2]
    _build.require(hd == KERNEL_HEAD_DIM,
                   f"{name}: the kernel takes head_dim {KERNEL_HEAD_DIM}, got {hd}")
    _build.require(not causal or Tq == Tk,
                   f"{name}: causal needs Tq == Tk, got {Tq} and {Tk}")
    _build.require(B <= 65535 and H <= 65535,
                   f"{name}: B={B}, H={H} exceed the grid")
    for key, t in tensors.items():
        if key in ("lse", "di"):
            _build.require(t.dtype == torch.float32 and t.is_contiguous()
                           and tuple(t.shape) == (B, H, Tq),
                           f"{name}: {key} must be fp32 [B, H, Tq] contiguous")
            continue
        rows = Tk if key in ("k", "v", "dk", "dv") else Tq
        _build.require(tuple(t.shape) == (B, H, rows, hd),
                       f"{name}: {key} must be [{B}, {H}, {rows}, {hd}], "
                       f"got {tuple(t.shape)}")
        _build.require(t.dtype == torch.bfloat16,
                       f"{name}: {key} must be bfloat16, got {t.dtype} (the "
                       f"kernel takes bf16 only: train with mixed_precision "
                       f"bf16, or pass --flash_attention off)")
        _build.require(t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
                       and t.data_ptr() % 16 == 0,
                       f"{name}: {key} needs a contiguous last dimension and "
                       f"strides that are multiples of 8, got {t.stride()}")


def _strides(*tensors):
    """(batch, head, row) element strides of each [B, H, T, hd] view, as the
    C entry points take them."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention_fwd(q, k, v, *, causal: bool = False):
    """q [B, H, Tq, 64], k/v [B, H, Tk, 64] -> (o [B, H, Tq, 64] in q's
    dtype, laid out as [B, Tq, H, 64] so merging heads is free;
    lse [B, H, Tq] fp32)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal=causal)
    global LAUNCHES
    name = "flash_attention_fwd"
    _require_kernel_args(name, causal, q=q, k=k, v=v)
    B, H, Tq, hd = q.shape
    o = torch.empty((B, Tq, H, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    _build.check(lib.sar_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _strides(q, k, v, o), B, H, Tq, k.shape[2], int(causal),
        q.device.index, _build.stream_of(q)), name)
    LAUNCHES += 1
    return o, lse


def flash_attention_bwd_dkv(q, k, v, do, lse, di, *, causal: bool = False):
    """(dk, dv), each laid out like k and v."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, di,
                                                 causal=causal)
    global DKV_LAUNCHES
    name = "flash_attention_bwd_dkv"
    _require_kernel_args(name, causal, q=q, k=k, v=v, do=do, lse=lse, di=di)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _require_kernel_args(name, causal, q=q, k=k, dk=dk, dv=dv)
    B, H, Tq, _ = q.shape
    lib = _build.load()
    _build.check(lib.sar_flash_attn_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, do, dk, dv), B, H, Tq, k.shape[2], int(causal),
        q.device.index, _build.stream_of(q)), name)
    DKV_LAUNCHES += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, di, *, causal: bool = False):
    """dq, laid out like q."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, di,
                                                causal=causal)
    global DQ_LAUNCHES
    name = "flash_attention_bwd_dq"
    _require_kernel_args(name, causal, q=q, k=k, v=v, do=do, lse=lse, di=di)
    dq = torch.empty_like(q)
    _require_kernel_args(name, causal, q=dq, k=k)
    B, H, Tq, _ = q.shape
    lib = _build.load()
    _build.check(lib.sar_flash_attn_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, do, dq), B, H, Tq, k.shape[2], int(causal),
        q.device.index, _build.stream_of(q)), name)
    DQ_LAUNCHES += 1
    return dq


# ---------------------------------------------------------------------------
# The custom op and its autograd
# ---------------------------------------------------------------------------

@torch.library.custom_op("sar_tpu_torch::flash_attention", mutates_args=())
def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(o [B, Tq, H, hd] contiguous, lse [B, H, Tq]): a fresh output the op
    owns (the [B, H, Tq, hd] view is taken outside it)."""
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    return o.transpose(1, 2).contiguous(), lse


def _setup_context(ctx, inputs, output):
    q, k, v, causal = inputs
    o, lse = output
    ctx.causal = causal
    ctx.save_for_backward(q, k, v, o, lse)


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    # di = rowsum(o * do) in fp32, outside the kernels as in the JAX package.
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    # An incoming gradient may have any strides: [B, Tq, H, hd] contiguous.
    do_h = do.to(q.dtype).contiguous().transpose(1, 2)          # [B, H, Tq, hd]
    dk, dv = flash_attention_bwd_dkv(q, k, v, do_h, lse, di, causal=ctx.causal)
    dq = flash_attention_bwd_dq(q, k, v, do_h, lse, di, causal=ctx.causal)
    return dq, dk, dv, None


torch.library.register_autograd("sar_tpu_torch::flash_attention", _backward,
                                setup_context=_setup_context)

# The op a selective-checkpoint policy saves (models/whisper.py::_remat).
FLASH_OP = torch.ops.sar_tpu_torch.flash_attention.default


def flash_mha_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool = False) -> torch.Tensor:
    """The custom-op path on any device (the kernels on CUDA, each kernel's
    plain version on the CPU) -> [B, H, Tq, hd]."""
    o, _ = torch.ops.sar_tpu_torch.flash_attention(q, k, v, causal)
    return o.transpose(1, 2)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False) -> torch.Tensor:
    """Blockwise attention: q [B, H, Tq, hd] x k/v [B, H, Tk, hd] ->
    [B, H, Tq, hd], with autograd. CPU tensors take `flash_mha_reference`;
    CUDA tensors the kernels (or raise)."""
    if q.device.type == "cpu":
        return flash_mha_reference(q, k, v, causal=causal)
    return flash_mha_op(q, k, v, causal)
