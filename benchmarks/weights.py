"""Seeded random Whisper weights, made by the benchmark in the layout the
port's entry points take (nested dicts of tensors; per-stack layer weights
stacked on a leading [L, ...] axis, linear weights [d_in, d_out], the
encoder convolutions [out, in, 3]).

Made on the device from `--seed` in a few large calls: one draw for every
matrix and bias (served type, bfloat16) and one for the LayerNorm
parameters (float32, as they are served), each leaf a view into its draw.
Matrices and biases ~ N(0, 0.02); LayerNorm scales 1 + N(0, 0.02) and
biases N(0, 0.02), so that no term of the model is zero; the encoder's
positions are Whisper's fixed sinusoids. The same seed gives the same
weights, so a run's reference makes them again after the window rather
than reading what the program holds.
"""

from __future__ import annotations

import numpy as np
import torch

STD = 0.02
ALIGN = 128          # leaf offsets in elements (256 bytes in bfloat16)

# The port's WhisperConfig fields that a configuration file states.
WIDTH_KEYS = ("d_model", "encoder_layers", "encoder_heads", "decoder_layers",
              "decoder_heads", "ffn_dim", "num_mel_bins", "vocab_size",
              "max_source_positions", "max_target_positions")


def check_config(cfg, config: dict) -> None:
    """Raise unless the port's config `cfg` has the file's sizes."""
    bad = {k: (getattr(cfg, k), config[k]) for k in WIDTH_KEYS
           if getattr(cfg, k) != config[k]}
    if bad:
        raise ValueError(f"{config['name']}: the port's {config['program_config']!r} "
                         f"differs from the file (port, file): {bad}")


def layout(c: dict) -> tuple[list, list]:
    """([(path, shape)] of the bfloat16 leaves, [(path, shape, kind)] of
    the float32 LayerNorm leaves) for configuration file `c`."""
    d, f, m = c["d_model"], c["ffn_dim"], c["num_mel_bins"]
    Le, Ld = c["encoder_layers"], c["decoder_layers"]
    mats, lns = [], []

    def lin(path, L, d_in, d_out, bias=True):
        mats.append((path + ("w",), (L, d_in, d_out)))
        if bias:
            mats.append((path + ("b",), (L, d_out)))

    def ln(path, shape):
        lns.append((path + ("scale",), shape, "scale"))
        lns.append((path + ("bias",), shape, "bias"))

    e = ("encoder",)
    mats += [(e + ("conv1", "w"), (d, m, 3)), (e + ("conv1", "b"), (d,)),
             (e + ("conv2", "w"), (d, d, 3)), (e + ("conv2", "b"), (d,))]
    el = e + ("layers",)
    ln(el + ("attn_ln",), (Le, d))
    for name in ("q", "k", "v", "o"):
        lin(el + (name,), Le, d, d, bias=name != "k")
    ln(el + ("mlp_ln",), (Le, d))
    lin(el + ("fc1",), Le, d, f)
    lin(el + ("fc2",), Le, f, d)
    ln(e + ("ln",), (d,))
    dc = ("decoder",)
    mats += [(dc + ("token_embed",), (c["vocab_size"], d)),
             (dc + ("pos_embed",), (c["max_target_positions"], d))]
    dl = dc + ("layers",)
    for side in ("self", "cross"):
        ln(dl + (f"{side}_ln",), (Ld, d))
        for name in ("q", "k", "v", "o"):
            lin(dl + (f"{side}_{name}",), Ld, d, d, bias=name != "k")
    ln(dl + ("mlp_ln",), (Ld, d))
    lin(dl + ("fc1",), Ld, d, f)
    lin(dl + ("fc2",), Ld, f, d)
    ln(dc + ("ln",), (d,))
    return mats, lns


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's fixed sinusoidal encoder positions [length, channels]."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], axis=1))


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _offsets(shapes) -> tuple[list[int], int]:
    offs, n = [], 0
    for shape in shapes:
        offs.append(n)
        n += -(-int(np.prod(shape)) // ALIGN) * ALIGN
    return offs, n


def generator(seed: int, device: torch.device, stream: int = 0) -> torch.Generator:
    """A torch generator on `device` for (seed, stream)."""
    state = np.random.SeedSequence([int(seed) % 2**63, stream]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) % 2**63)


def make(c: dict, seed: int, device: torch.device | str) -> dict:
    """The weights of configuration file `c` for `seed` on `device`."""
    device = torch.device(device)
    mats, lns = layout(c)
    g = generator(seed, device, stream=1)
    offs, n = _offsets([s for _, s in mats])
    flat = torch.randn(n, generator=g, device=device, dtype=torch.bfloat16).mul_(STD)
    loffs, ln_n = _offsets([s for _, s, _ in lns])
    lflat = torch.randn(ln_n, generator=g, device=device, dtype=torch.float32).mul_(STD)
    tree: dict = {}
    for (path, shape), o in zip(mats, offs):
        _put(tree, path, flat[o:o + int(np.prod(shape))].view(shape))
    for (path, shape, kind), o in zip(lns, loffs):
        leaf = lflat[o:o + int(np.prod(shape))].view(shape)
        _put(tree, path, leaf.add_(1.0) if kind == "scale" else leaf)
    tree["encoder"]["pos_embed"] = sinusoids(c["max_source_positions"], c["d_model"]).to(
        device=device, dtype=torch.bfloat16)
    return tree
