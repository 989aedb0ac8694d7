"""Weight bridge between the JAX package's parameter pytrees and the
port's, and the PEFT adapter import.

Both sides are nested dicts with stacked [L, ...] layer leaves and [d_in,
d_out] linear weights; the only layout change is the convolutions: HIO
[k, in, out] on the JAX side, [out, in, k] (what F.conv1d takes) here. That
covers the Whisper encoder's `conv1`/`conv2` and the LID classifier's CNN
front `cnn1`/`cnn2`, so the same two functions carry model params, LoRA
banks (no layout change) and classifier params. The port's
`decoder.token_embed_f32` (see whisper.cast_params) has no JAX counterpart
and is dropped on the way back. bf16 leaves travel bit-exactly as int16 bit
patterns. The HF state-dict mapping is a later slice.

PEFT `save_pretrained` directories (adapter_config.json plus
adapter_model.safetensors or .bin, keys such as
`base_model.model.model.encoder.layers.0.self_attn.q_proj.lora_A.weight`)
import as single-adapter banks: lora_A [r, d_in] and lora_B [d_out, r]
become a = A^T [d, r] and b = B^T [r, d], so scale * (x @ a) @ b is PEFT's
delta.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch

from sar_tpu_torch.models.config import WhisperConfig

CONV_KEYS = ("conv1", "conv2", "cnn1", "cnn2")
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
    """sar_tpu params, bank or classifier params (numpy or jax array leaves)
    -> the port's on `device`, same dtypes."""
    return _walk(tree, lambda a, conv: _to_torch(a, device, conv))


def to_jax_params(params: dict) -> dict:
    """Port params -> the sar_tpu pytree layout with numpy leaves (inverse of
    from_jax_params)."""
    return _walk(params, _to_numpy)


def flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """{"a": {"b": leaf}} -> {"a/b": numpy} (the npz key scheme of the
    adapter and classifier files); tensor leaves are written as fp32."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().float().cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat: dict[str, np.ndarray]) -> dict:
    """Inverse of flatten (numpy leaves)."""
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


# ---------------------------------------------------------------------------
# PEFT adapter import
# ---------------------------------------------------------------------------

_PEFT_KEY_RE = re.compile(
    r"(?:.*\.)?model\.(encoder|decoder)\.layers\.(\d+)\."
    r"(self_attn|encoder_attn)\.(q_proj|k_proj|v_proj|out_proj)\."
    r"lora_(A|B)(?:\.[^.]+)?\.weight$")

# (side, attn, target) -> the per-stack hook key (see lora._TARGET_MAP).
_PEFT_HOOKS = {
    ("encoder", "self_attn", "q_proj"): "q",
    ("encoder", "self_attn", "k_proj"): "k",
    ("encoder", "self_attn", "v_proj"): "v",
    ("encoder", "self_attn", "out_proj"): "o",
    ("decoder", "self_attn", "q_proj"): "self_q",
    ("decoder", "self_attn", "k_proj"): "self_k",
    ("decoder", "self_attn", "v_proj"): "self_v",
    ("decoder", "self_attn", "out_proj"): "self_o",
    ("decoder", "encoder_attn", "q_proj"): "cross_q",
    ("decoder", "encoder_attn", "k_proj"): "cross_k",
    ("decoder", "encoder_attn", "v_proj"): "cross_v",
    ("decoder", "encoder_attn", "out_proj"): "cross_o",
}


def _np32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def lora_from_peft_state_dict(sd: dict, cfg: WhisperConfig) -> dict:
    """PEFT LoRA tensors (a state dict of torch tensors or numpy arrays) ->
    a single-adapter bank of fp32 numpy leaves ({side: {hook: {a: [L, 1, d,
    r], b: [L, 1, r, d]}}}). Layers a hook never names stay zero: a zero
    delta, so the import is exact."""
    found: dict[tuple[str, str, str], dict[int, np.ndarray]] = {}
    for key, tensor in sd.items():
        m = _PEFT_KEY_RE.match(key)
        if not m:
            continue
        side, layer, attn, target, ab = m.groups()
        hook = _PEFT_HOOKS[(side, attn, target)]
        found.setdefault((side, hook, ab), {})[int(layer)] = _np32(tensor)
    if not found:
        raise ValueError("no PEFT lora_A/lora_B whisper keys found in "
                         f"state_dict ({len(sd)} entries)")
    ranks = {t.shape[0 if ab == "A" else 1]
             for (_, _, ab), lt in found.items() for t in lt.values()}
    if len(ranks) != 1:
        raise ValueError(f"mixed LoRA ranks in one PEFT checkpoint: {ranks}; "
                         "import each rank separately and combine with "
                         "lora.stack_adapters")
    r = ranks.pop()

    bank: dict = {"encoder": {}, "decoder": {}}
    n_layers = {"encoder": cfg.encoder_layers, "decoder": cfg.decoder_layers}
    for (side, hook, ab), per_layer in found.items():
        L = n_layers[side]
        sample = next(iter(per_layer.values()))
        d = sample.shape[1] if ab == "A" else sample.shape[0]
        shape = (L, 1, d, r) if ab == "A" else (L, 1, r, d)
        stacked = np.zeros(shape, np.float32)
        for layer, t in per_layer.items():
            if layer >= L:
                raise ValueError(f"PEFT key references layer {layer} but "
                                 f"{side} has {L} layers")
            stacked[layer, 0] = t.T
        bank[side].setdefault(hook, {})["a" if ab == "A" else "b"] = stacked
    for side in list(bank):
        for hook, entry in bank[side].items():
            if set(entry) != {"a", "b"}:
                raise ValueError(f"incomplete PEFT pair for {side}/{hook}: "
                                 f"has {sorted(entry)}")
        if not bank[side]:
            del bank[side]
    return bank


def lora_from_peft(path, cfg: WhisperConfig):
    """A PEFT `save_pretrained` directory -> (bank of numpy leaves,
    LoraConfig). Reads adapter_model.safetensors (safetensors is imported
    only then) or the legacy adapter_model.bin (torch.load)."""
    from sar_tpu_torch.models.lora import LoraConfig

    path = Path(path)
    pcfg = json.loads((path / "adapter_config.json").read_text())
    if pcfg.get("peft_type", "LORA").upper() != "LORA":
        raise ValueError(f"not a LoRA PEFT checkpoint: {pcfg.get('peft_type')}")
    for unsupported in ("use_rslora", "use_dora"):
        if pcfg.get(unsupported):
            raise ValueError(f"PEFT option {unsupported} is not supported")
    if pcfg.get("rank_pattern") or pcfg.get("alpha_pattern"):
        raise ValueError("PEFT rank_pattern/alpha_pattern are not supported")

    st_file = path / "adapter_model.safetensors"
    if st_file.exists():
        from safetensors.numpy import load_file
        sd = load_file(st_file)
    else:
        bin_file = path / "adapter_model.bin"
        if not bin_file.exists():
            raise FileNotFoundError(
                f"no adapter_model.safetensors or .bin under {path}")
        sd = torch.load(bin_file, map_location="cpu", weights_only=True)

    bank = lora_from_peft_state_dict(sd, cfg)
    lcfg = LoraConfig(
        r=int(pcfg["r"]), alpha=int(pcfg["lora_alpha"]),
        dropout=float(pcfg.get("lora_dropout", 0.0)),
        target_modules=tuple(sorted(pcfg.get("target_modules") or
                                    ("q_proj", "v_proj"))))
    return bank, lcfg


def is_peft_checkpoint(path) -> bool:
    """True when `path` is a PEFT save_pretrained directory rather than a
    sar_tpu / sar_tpu_torch adapter directory."""
    path = Path(path)
    return ((path / "adapter_model.safetensors").exists()
            or (path / "adapter_model.bin").exists())
