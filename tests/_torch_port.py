"""Shared setup of the sar_tpu_torch port tests (tests/test_torch_*.py).

Importing it pins torch to one thread per process — the suite runs under
several xdist workers — and it holds the helpers that hand the same
numpy-made data and JAX-made weights to both packages. JAX runs on the CPU
(tests/conftest.py); data crosses between the frameworks as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(1)


def to_numpy(tree):
    """A JAX pytree (nested dicts of arrays) as nested dicts of numpy."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def t(x) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def jax_whisper(cfg, seed: int = 0, w_scale: float = 1.0):
    """(JAX params, the same weights as port params), fp32, on the CPU.
    `w_scale` multiplies every weight matrix: at the init's std of 0.02 a
    tiny random model says nearly the same thing whatever the input, and
    larger weights make its outputs depend on the input."""
    import jax

    from sar_tpu.models import whisper as jw
    from sar_tpu_torch.models.convert import from_jax_params

    jp = jw.init_params(jax.random.PRNGKey(seed), cfg)
    if w_scale != 1.0:
        jp = jax.tree_util.tree_map_with_path(
            lambda path, x: (x * w_scale if getattr(path[-1], "key", None) == "w"
                             and x.ndim >= 2 else x), jp)
    return jp, from_jax_params(to_numpy(jp))


def random_bank(cfg, num_adapters: int, r: int, seed: int = 0,
                targets=("q_proj", "v_proj"), std: float = 0.05):
    """(JAX bank, the same bank for the port): every A and B drawn N(0, std)
    with numpy, so the deltas are not zero."""
    import jax.numpy as jnp

    from sar_tpu_torch.models import lora as tl

    rng = np.random.default_rng(seed)
    shapes = tl.init_lora(torch.Generator().manual_seed(0), cfg,
                          tl.LoraConfig(r=r, target_modules=tuple(targets)),
                          num_adapters)
    np_bank = {side: {hook: {k: (rng.standard_normal(tuple(v.shape)) * std)
                             .astype(np.float32) for k, v in e.items()}
                      for hook, e in hooks.items()}
               for side, hooks in shapes.items()}
    jax_bank = {s: {h: {k: jnp.asarray(v) for k, v in e.items()}
                    for h, e in hooks.items()} for s, hooks in np_bank.items()}
    port_bank = {s: {h: {k: torch.from_numpy(v.copy()) for k, v in e.items()}
                     for h, e in hooks.items()} for s, hooks in np_bank.items()}
    return jax_bank, port_bank
