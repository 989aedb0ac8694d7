"""Language-identification (LID) classifier in PyTorch (counterpart of
sar_tpu/models/classifier.py; training/lid_trainer.py trains it).

- optional input LayerNorm, optional 2-layer 1-D CNN front (kernel 5,
  padding k//2, ReLU), MLP of Linear + LayerNorm + ReLU, softmax; in
  training (`train=True` with a generator) inverted dropout after each CNN
  layer and each MLP layer, as the JAX package places it (the masks come
  from torch's generator, not jax.random);
- pooling mean | max | attention (a Tanh-MLP scorer softmaxed over time),
  each mask-aware;
- the weighted, label-smoothed cross entropy (torch CrossEntropyLoss
  semantics) and the class-weight strategies;
- save / load in the JAX package's format (classifier_config.json +
  classifier_params.npz, conv weights HIO [k, in, out]), so a head saved by
  either package loads in the other;
- `encode_features`: the frozen encoder's features for LID, from the final
  post-LN output (layer -1) or tapped after encoder layer k >= 0, which
  runs only the first k+1 layers.

Params are nested dicts of fp32 tensors with [d_in, d_out] linear weights;
the CNN weights are kept as F.conv1d takes them, [out, in, k].
Everything runs in fp32 whatever the features' dtype.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from sar_tpu_torch.models import convert
from sar_tpu_torch.models.config import WhisperConfig


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    input_dim: int = 768
    hidden_dims: tuple[int, ...] = (256, 128)
    num_classes: int = 4
    dropout: float = 0.3
    pooling: str = "mean"               # mean | max | attention
    use_layer_norm: bool = True
    use_cnn: bool = False
    cnn_channels: int = 256
    cnn_kernel_size: int = 5
    label_smoothing: float = 0.0
    languages: tuple[str, ...] = ("hindi", "italian", "punjabi", "telugu")
    class_weights: tuple[float, ...] | None = None
    # The encoder layer the head was trained on (-1 = final post-LN
    # output); inference taps the same layer.
    encoder_layer: int = -1

    def lang_to_idx(self, lang: str) -> int:
        return self.languages.index(lang)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hidden_dims"] = list(self.hidden_dims)
        d["languages"] = list(self.languages)
        d["class_weights"] = (list(self.class_weights)
                              if self.class_weights is not None else None)
        return d

    @staticmethod
    def from_dict(d: dict) -> "ClassifierConfig":
        d = dict(d)
        for k in ("hidden_dims", "languages"):
            if k in d and d[k] is not None:
                d[k] = tuple(d[k])
        if d.get("class_weights") is not None:
            d["class_weights"] = tuple(d["class_weights"])
        return ClassifierConfig(**d)


def compute_class_weights_from_counts(
        class_counts: dict[str, int], languages: list[str] | tuple[str, ...],
        strategy: str = "inverse_freq", max_weight: float | None = None,
        smoothing: float = 0.0) -> np.ndarray:
    """Per-class loss weights from class counts (mean 1): inverse_freq,
    inverse_sqrt or effective_samples (class-balanced loss, beta 0.9999),
    optionally clipped at `max_weight` and smoothed towards uniform."""
    counts = np.asarray([class_counts.get(l, 1) for l in languages], np.float64)
    total, n = counts.sum(), len(languages)
    if strategy == "inverse_freq":
        weights = total / (n * counts)
    elif strategy == "inverse_sqrt":
        weights = np.sqrt(counts.max() / counts)
    elif strategy == "effective_samples":
        beta = 0.9999
        eff = 1.0 - np.power(beta, counts)
        weights = (1.0 - beta) / eff
        weights = weights / weights.sum() * n
    else:
        raise ValueError(f"Unknown strategy: {strategy}")
    weights = weights / weights.mean()
    if max_weight is not None:
        weights = np.minimum(weights, max_weight)
        weights = weights / weights.mean()
    if smoothing > 0:
        weights = (1 - smoothing) * weights + smoothing
        weights = weights / weights.mean()
    return weights.astype(np.float32)


# ---------------------------------------------------------------------------
# Init / apply
# ---------------------------------------------------------------------------

def _uniform(g: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=g, device=g.device) * 2 - 1) * bound


def _init_linear(g, d_in, d_out):
    # torch-default-style uniform(-1/sqrt(d_in), 1/sqrt(d_in)).
    bound = 1.0 / np.sqrt(d_in)
    return {"w": _uniform(g, (d_in, d_out), bound),
            "b": _uniform(g, (d_out,), bound)}


def _ln_params(d, device):
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def init_classifier(generator: torch.Generator, ccfg: ClassifierConfig) -> dict:
    """Random fp32 params drawn from `generator` on its own device."""
    g, dev = generator, generator.device
    p: dict = {}
    d = ccfg.input_dim
    if ccfg.use_layer_norm:
        p["ln"] = _ln_params(d, dev)
    feat_dim = d
    if ccfg.use_cnn:
        k, c = ccfg.cnn_kernel_size, ccfg.cnn_channels
        p["cnn1"] = {"w": _uniform(g, (c, d, k), 1 / np.sqrt(d * k)),
                     "b": torch.zeros((c,), device=dev)}
        p["cnn2"] = {"w": _uniform(g, (c, c, k), 1 / np.sqrt(c * k)),
                     "b": torch.zeros((c,), device=dev)}
        feat_dim = c
    prev = feat_dim
    for i, h in enumerate(ccfg.hidden_dims):
        p[f"mlp_{i}"] = _init_linear(g, prev, h)
        p[f"mlp_ln_{i}"] = _ln_params(h, dev)
        prev = h
    p["out"] = _init_linear(g, prev, ccfg.num_classes)
    if ccfg.pooling == "attention":
        p["attn1"] = _init_linear(g, feat_dim, 128)
        p["attn2"] = _init_linear(g, 128, 1)
    return p


def _ln(x, p, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _pool(params, ccfg, feats, mask):
    """feats [B, T, C] fp32; mask [B, T] bool or None -> [B, C]."""
    if ccfg.pooling == "mean":
        if mask is None:
            return feats.mean(1)
        m = mask[..., None].to(feats.dtype)
        return (feats * m).sum(1) / (m.sum(1) + 1e-8)
    if ccfg.pooling == "max":
        if mask is not None:
            feats = feats.masked_fill(~mask[..., None], -torch.inf)
        return feats.amax(1)
    if ccfg.pooling == "attention":
        h = torch.tanh(feats @ params["attn1"]["w"] + params["attn1"]["b"])
        scores = h @ params["attn2"]["w"] + params["attn2"]["b"]   # [B, T, 1]
        if mask is not None:
            scores = scores.masked_fill(~mask[..., None], -torch.inf)
        return (feats * torch.softmax(scores, dim=1)).sum(1)
    raise ValueError(f"Unknown pooling: {ccfg.pooling}")


def _dropout(x: torch.Tensor, rate: float,
             generator: torch.Generator | None,
             rows: tuple[int, int, int] | None = None) -> torch.Tensor:
    """Inverted dropout: keep with probability 1 - rate, scale by
    1 / (1 - rate); the identity without a generator or at rate 0. `rows`
    (lo, hi, n): x holds rows [lo, hi) of a batch of n (a data-parallel
    shard), and the mask is the whole batch's at those rows."""
    if generator is None or rate <= 0.0:
        return x
    shape = x.shape if rows is None else (rows[2],) + tuple(x.shape[1:])
    keep = torch.rand(shape, generator=generator, device=x.device) < 1 - rate
    if rows is not None:
        keep = keep[rows[0]:rows[1]]
    return x * keep / (1 - rate)


def apply_classifier(params: dict, ccfg: ClassifierConfig,
                     hidden_states: torch.Tensor,
                     attention_mask: torch.Tensor | None = None,
                     labels: torch.Tensor | None = None, train: bool = False,
                     generator: torch.Generator | None = None,
                     rows: tuple[int, int, int] | None = None) -> dict:
    """Forward pass -> {"logits", "probs", "loss"}; the loss only when
    `labels` are given. `train` with a `generator` (on the features'
    device) applies the classifier's dropout, with masks of the whole
    batch when `rows` says the features are a shard of it (`_dropout`)."""
    x = hidden_states.float()
    g = generator if train else None
    if ccfg.use_layer_norm:
        x = _ln(x, params["ln"])
    if ccfg.use_cnn:
        x = x.transpose(1, 2)                                       # [B, C, T]
        for name in ("cnn1", "cnn2"):
            x = F.relu(F.conv1d(x, params[name]["w"], params[name]["b"],
                                padding=ccfg.cnn_kernel_size // 2))
            x = _dropout(x, ccfg.dropout, g, rows)
        x = x.transpose(1, 2)
    h = _pool(params, ccfg, x, attention_mask)
    for i in range(len(ccfg.hidden_dims)):
        h = h @ params[f"mlp_{i}"]["w"] + params[f"mlp_{i}"]["b"]
        h = _dropout(F.relu(_ln(h, params[f"mlp_ln_{i}"])), ccfg.dropout, g, rows)
    logits = h @ params["out"]["w"] + params["out"]["b"]
    loss = classifier_loss(logits, labels, ccfg) if labels is not None else None
    return {"logits": logits, "probs": torch.softmax(logits, -1), "loss": loss}


def loss_weight(labels: torch.Tensor, ccfg: ClassifierConfig) -> torch.Tensor:
    """The denominator of `classifier_loss` over `labels`: their count, or
    their summed class weights (before the 1e-8 floor)."""
    if ccfg.class_weights is None:
        return torch.tensor(float(labels.shape[0]), device=labels.device)
    w = torch.tensor(ccfg.class_weights, dtype=torch.float32, device=labels.device)
    return w[labels.long()].sum()


def classifier_loss(logits, labels, ccfg: ClassifierConfig):
    """torch CrossEntropyLoss semantics: label smoothing and per-class
    weights (the weighted mean normalised by the targets' summed weights)."""
    K = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), -1)
    eps = ccfg.label_smoothing
    labels = labels.long()
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    if ccfg.class_weights is None:
        smooth = -logp.mean(-1)
        return ((1 - eps) * nll + eps * smooth).mean()
    w = torch.tensor(ccfg.class_weights, dtype=torch.float32, device=logits.device)
    wy = w[labels]
    smooth = -(logp * w[None, :]).sum(-1) / K
    return ((1 - eps) * (nll * wy).sum() + eps * smooth.sum()) \
        / wy.sum().clamp_min(1e-8)


def predict(params, ccfg, hidden_states, attention_mask=None):
    """(labels [B] int64, probs [B, K])."""
    probs = apply_classifier(params, ccfg, hidden_states, attention_mask)["probs"]
    return probs.argmax(-1), probs


def predict_language(params, ccfg, hidden_states, attention_mask=None):
    """(language names, probs)."""
    labels, probs = predict(params, ccfg, hidden_states, attention_mask)
    return [ccfg.languages[int(i)] for i in labels.tolist()], probs


# ---------------------------------------------------------------------------
# Encoder features for LID
# ---------------------------------------------------------------------------

@torch.no_grad()
def encode_features(base_params: dict, mel: torch.Tensor, cfg: WhisperConfig,
                    layer_index: int = -1,
                    flash: bool | str = False, tp=None) -> torch.Tensor:
    """Frozen encoder features [B, T, d] for LID. layer_index=-1: the final
    post-LN output (whisper.encode); k >= 0: the output of encoder layer k
    (0-based), running only the first k+1 layers, without the final LN.
    `flash` as in whisper.encode ("hm" launches the attention kernel on T
    padded to cross_pad_len); a tap layer takes "fq" as "hm", as the JAX
    package does, while layer_index=-1 passes it on to whisper.encode.
    `tp`: the "model" group of a tensor-parallel shard of `base_params`
    (whisper.encoder_layers)."""
    from sar_tpu_torch.models import whisper

    if layer_index == -1:
        return whisper.encode(base_params, mel, cfg, flash=flash, tp=tp)
    if flash == "fq":
        flash = "hm"            # no LoRA here, but fq buys nothing for taps
    enc = base_params["encoder"]
    L = enc["layers"]["q"]["w"].shape[0]
    k = layer_index if layer_index >= 0 else L + layer_index
    if not 0 <= k < L:
        raise ValueError(f"layer_index {layer_index} out of range for "
                         f"{L}-layer encoder")
    x = whisper.encoder_front(enc, mel, tp)
    return whisper.encoder_layers(enc, x, cfg, k + 1, flash=flash, tp=tp)


def get_hidden_dim(cfg: WhisperConfig) -> int:
    """The width of the encoder features the head takes (d_model)."""
    return cfg.d_model


class LanguageClassifier:
    """(params, config) handle with the reference's method names; compute
    goes through apply_classifier / predict."""

    def __init__(self, config: ClassifierConfig, params: dict | None = None,
                 seed: int = 0):
        self.config = config
        self.params = params if params is not None else init_classifier(
            torch.Generator().manual_seed(seed), config)

    def __call__(self, hidden_states, attention_mask=None, labels=None):
        return apply_classifier(self.params, self.config, hidden_states,
                                attention_mask, labels)

    forward = __call__

    def predict(self, hidden_states, attention_mask=None):
        return predict(self.params, self.config, hidden_states, attention_mask)

    def predict_language(self, hidden_states, attention_mask=None):
        return predict_language(self.params, self.config, hidden_states,
                                attention_mask)

    def save(self, path, metadata=None):
        save_classifier(path, self.params, self.config, metadata)

    @staticmethod
    def load(path, device: torch.device | str = "cpu") -> "LanguageClassifier":
        params, cfg, _ = load_classifier(path, device)
        return LanguageClassifier(cfg, params)


# ---------------------------------------------------------------------------
# Save / load (the JAX package's npz format)
# ---------------------------------------------------------------------------

def save_classifier(path: str | Path, params: dict, ccfg: ClassifierConfig,
                    metadata: dict | None = None) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "classifier_config.json").write_text(json.dumps(
        {"config": ccfg.to_dict(), "metadata": metadata or {}}, indent=2))
    np.savez(path / "classifier_params.npz",
             **convert.flatten(convert.to_jax_params(params)))


def load_classifier(path: str | Path, device: torch.device | str = "cpu"
                    ) -> tuple[dict, ClassifierConfig, dict]:
    path = Path(path)
    blob = json.loads((path / "classifier_config.json").read_text())
    with np.load(path / "classifier_params.npz") as z:
        params = convert.from_jax_params(
            convert.unflatten({k: z[k] for k in z.files}), device)
    return params, ClassifierConfig.from_dict(blob["config"]), blob.get("metadata", {})
