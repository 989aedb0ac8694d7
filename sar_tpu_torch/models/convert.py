"""Weight bridge between the JAX package's parameter pytree and the port's.

Both sides are nested dicts with stacked [L, ...] layer leaves and [d_in,
d_out] linear weights; the only layout change is the encoder convolutions:
HIO [3, in, out] on the JAX side, [out, in, 3] (what F.conv1d takes) here.
The port's `decoder.token_embed_f32` (see whisper.cast_params) has no JAX
counterpart and is dropped on the way back. bf16 leaves travel bit-exactly
as int16 bit patterns. The HF state-dict mapping is a later slice.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

CONV_KEYS = ("conv1", "conv2")
PORT_ONLY_KEYS = ("token_embed_f32",)


def _to_torch(a: Any, device, transpose: bool) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.int16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if transpose:
        t = t.permute(2, 1, 0).contiguous()
    return t.to(device)


def _to_numpy(t: torch.Tensor, transpose: bool) -> np.ndarray:
    t = t.detach().cpu()
    if transpose:
        t = t.permute(2, 1, 0)
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # the JAX side's bf16 numpy dtype
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _walk(tree, leaf_fn, path=()):
    out = {}
    for k, v in tree.items():
        if k in PORT_ONLY_KEYS:
            continue
        if isinstance(v, dict):
            out[k] = _walk(v, leaf_fn, path + (k,))
        else:
            conv_w = k == "w" and len(path) >= 1 and path[-1] in CONV_KEYS
            out[k] = leaf_fn(v, conv_w)
    return out


def from_jax_params(tree: dict, device: torch.device | str = "cpu") -> dict:
    """sar_tpu params (numpy or jax array leaves) -> port params on `device`,
    same dtypes."""
    return _walk(tree, lambda a, conv: _to_torch(a, device, conv))


def to_jax_params(params: dict) -> dict:
    """Port params -> the sar_tpu pytree layout with numpy leaves (inverse of
    from_jax_params)."""
    return _walk(params, _to_numpy)
