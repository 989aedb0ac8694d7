"""Shared setup of the sar_tpu_torch port tests (tests/test_torch_*.py).

Importing it pins torch to one thread per process — the suite runs under
several xdist workers — and it holds the helpers that hand the same
numpy-made data and JAX-made weights to both packages. JAX runs on the CPU
(tests/conftest.py); data crosses between the frameworks as numpy arrays.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

torch.set_num_threads(1)


def whisper_fields_equal(a, b) -> bool:
    """The JAX package's config `a` and the port's `b` equal on every field
    of a, and b's port-only fields (those of the architecture family, which
    the JAX package's config lacks) at their Whisper defaults."""
    from sar_tpu_torch.models.config import WhisperConfig
    ours, theirs = dataclasses.asdict(b), dataclasses.asdict(a)
    defaults = {f.name: f.default for f in dataclasses.fields(WhisperConfig)
                if f.name not in theirs}
    return ({k: ours[k] for k in theirs} == theirs
            and {k: ours[k] for k in defaults} == defaults)


def port_config(cfg):
    """The port's WhisperConfig of the JAX package's config `cfg`: its
    fields, and the port's architecture-family fields at their Whisper
    defaults. Both packages take it."""
    from sar_tpu_torch.models.config import WhisperConfig
    return WhisperConfig(**dataclasses.asdict(cfg))


def get_config(name: str):
    """The JAX package's config of model `name`, as `port_config` gives it."""
    from sar_tpu.models.config import get_config as jax_config
    return port_config(jax_config(name))


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


@contextlib.contextmanager
def one_process_mesh(tmp_path):
    """A ("data", "model") mesh of 1 x 1 over a gloo group of one process
    (a file rendezvous under `tmp_path`), taken down on exit."""
    import torch.distributed as dist

    from sar_tpu_torch.parallel.sharding import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous",
                            world_size=1, rank=0)
    try:
        yield make_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def bf16_rounding_case(T_pad: int = 8):
    """q [1, T_pad, 64] bf16 (one head) whose two valid keys score 0 and
    -2^-10 against every query, with values +1 and -1; the keys and values
    past them are large garbage. The probabilities are 1 and
    exp(-2^-10) = 0.99902, which bf16 rounds to 1.0: rounded before the PV
    product (as the TPU kernel's `p.astype(qg.dtype)`), the output is
    exactly 0; kept in fp32 it is (1 - 0.99902) / 1.99902 = 4.88e-4."""
    rng = np.random.default_rng(11)
    q = np.zeros((1, T_pad, 64), np.float32)
    q[..., 0] = 1.0
    k = rng.standard_normal((1, T_pad, 64)).astype(np.float32) * 3.0
    k[:, :2] = 0.0
    k[0, 1, 0] = -2.0 ** -10
    v = rng.standard_normal((1, T_pad, 64)).astype(np.float32) * 3.0
    v[:, 0], v[:, 1] = 1.0, -1.0
    return q, k, v
