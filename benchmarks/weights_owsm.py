"""Seeded random OWSM weights (an E-Branchformer encoder behind a conv2d
subsampling, a Transformer decoder with untied logits), made by the
benchmark in their published form: every Linear with its bias (k's
included), no sqrt(d) folded into any weight and no position table. The
port's `ebranchformer.port_params` turns them into its serving form; the
plain reference (`reference/owsm.py`) reads them as they are.

The port's nesting: per-stack layer weights stacked on a leading [L, ...]
axis, linear weights [d_in, d_out], the subsampling's convolutions as
F.conv2d takes them ([out, in, 3, 3]) and the depthwise time convolutions
as F.conv1d takes them ([C, 1, kernel]). Made on the device from `--seed`
in one draw for every matrix, bias and convolution (bfloat16, N(0, 0.02)),
one for the LayerNorms (float32: scales 1 + N(0, 0.02), biases
N(0, 0.02)) and one for the feature statistics (float32, per mel bin:
mean N(0, 1), std 1 + |N(0, 1)|), each leaf a view into its draw, as
`weights.py` makes Whisper's.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmarks import weights

# The OWSM fields of the port's config that a configuration file states,
# beside weights.WIDTH_KEYS.
OWSM_KEYS = ("cgmlp_dim", "cgmlp_kernel", "merge_kernel")


def check_config(cfg, config: dict) -> None:
    """Raise unless the port's config `cfg` has the file's sizes."""
    weights.check_config(cfg, config)
    bad = {k: (getattr(cfg, k), config[k]) for k in OWSM_KEYS
           if getattr(cfg, k) != config[k]}
    if bad or cfg.encoder_kind != "ebranchformer":
        raise ValueError(f"{config['name']}: the port's {config['program_config']!r} "
                         f"differs from the file (port, file): {bad}")


def subsampled_bins(mels: int) -> int:
    """Frequency bins left by the two 3x3 stride-2 convolutions."""
    return ((mels - 1) // 2 - 1) // 2


def layout(c: dict) -> tuple[list, list]:
    """([(path, shape)] of the bfloat16 leaves, [(path, shape, kind)] of
    the float32 LayerNorm leaves) for configuration file `c`."""
    d, f, g, m = c["d_model"], c["ffn_dim"], c["cgmlp_dim"], c["num_mel_bins"]
    Le, Ld = c["encoder_layers"], c["decoder_layers"]
    mats, lns = [], []

    def lin(path, L, d_in, d_out):
        mats.append((path + ("w",), (L, d_in, d_out)))
        mats.append((path + ("b",), (L, d_out)))

    def ln(path, shape):
        lns.append((path + ("scale",), shape, "scale"))
        lns.append((path + ("bias",), shape, "bias"))

    e = ("encoder",)
    mats += [(e + ("sub_conv1", "w"), (d, 1, 3, 3)), (e + ("sub_conv1", "b"), (d,)),
             (e + ("sub_conv2", "w"), (d, d, 3, 3)), (e + ("sub_conv2", "b"), (d,))]
    mats += [(e + ("sub_out", "w"), (d * subsampled_bins(m), d)), (e + ("sub_out", "b"), (d,))]
    el = e + ("layers",)
    for ff in ("ff1", "ff2"):
        ln(el + (f"{ff}_ln",), (Le, d))
        lin(el + (f"{ff}_up",), Le, d, f)
        lin(el + (f"{ff}_down",), Le, f, d)
    ln(el + ("attn_ln",), (Le, d))
    for name in ("q", "k", "v", "o"):
        lin(el + (name,), Le, d, d)
    ln(el + ("cgmlp_ln",), (Le, d))
    lin(el + ("cgmlp_up",), Le, d, g)
    ln(el + ("cgmlp_gate_ln",), (Le, g // 2))
    mats += [(el + ("cgmlp_conv", "w"), (Le, g // 2, 1, c["cgmlp_kernel"])),
             (el + ("cgmlp_conv", "b"), (Le, g // 2))]
    lin(el + ("cgmlp_down",), Le, g // 2, d)
    mats += [(el + ("merge_conv", "w"), (Le, 2 * d, 1, c["merge_kernel"])),
             (el + ("merge_conv", "b"), (Le, 2 * d))]
    lin(el + ("merge",), Le, 2 * d, d)
    ln(el + ("final_ln",), (Le, d))
    ln(e + ("ln",), (d,))
    dc = ("decoder",)
    mats.append((dc + ("token_embed",), (c["vocab_size"], d)))
    dl = dc + ("layers",)
    for side in ("self", "cross"):
        ln(dl + (f"{side}_ln",), (Ld, d))
        for name in ("q", "k", "v", "o"):
            lin(dl + (f"{side}_{name}",), Ld, d, d)
    ln(dl + ("mlp_ln",), (Ld, d))
    lin(dl + ("fc1",), Ld, d, f)
    lin(dl + ("fc2",), Ld, f, d)
    ln(dc + ("ln",), (d,))
    mats += [(dc + ("out", "w"), (d, c["vocab_size"])), (dc + ("out", "b"), (c["vocab_size"],))]
    return mats, lns


def make(c: dict, seed: int, device: torch.device | str) -> dict:
    """The published-form weights of configuration file `c` for `seed` on
    `device`, with the feature statistics under "mvn"."""
    device = torch.device(device)
    mats, lns = layout(c)
    g = weights.generator(seed, device, stream=1)
    offs, n = weights._offsets([s for _, s in mats])
    flat = torch.randn(n, generator=g, device=device, dtype=torch.bfloat16).mul_(weights.STD)
    loffs, ln_n = weights._offsets([s for _, s, _ in lns])
    lflat = torch.randn(ln_n, generator=g, device=device, dtype=torch.float32).mul_(weights.STD)
    tree: dict = {}
    for (path, shape), o in zip(mats, offs):
        weights._put(tree, path, flat[o:o + int(np.prod(shape))].view(shape))
    for (path, shape, kind), o in zip(lns, loffs):
        leaf = lflat[o:o + int(np.prod(shape))].view(shape)
        weights._put(tree, path, leaf.add_(1.0) if kind == "scale" else leaf)
    stats = torch.randn((2, c["num_mel_bins"]), generator=weights.generator(seed, device, stream=2),
                        device=device, dtype=torch.float32)
    tree["mvn"] = {"mean": stats[0], "std": 1.0 + stats[1].abs()}
    return tree
