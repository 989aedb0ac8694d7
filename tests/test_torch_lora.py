"""The port's LoRA bank (models/lora.py, the PEFT import of
models/convert.py, whisper.lora_delta) against sar_tpu on the CPU: deltas
within 1e-5 in both forms (one adapter for the batch, and masked-dense
routing per row), mixed-rank stacking and merging equal, adapter
directories loadable across the two packages, and a PEFT state dict
imported to the same bank."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper, random_bank, t

from sar_tpu.models import convert as jconvert
from sar_tpu.models import lora as jlora
from sar_tpu.models import whisper as jw
from sar_tpu_torch.models import convert as tconvert
from sar_tpu_torch.models import lora as tlora
from sar_tpu_torch.models import whisper as tw

CFG = get_config("whisper-test")


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _assert_trees_equal(a, b, atol=0.0):
    a, b = _np_tree(a), _np_tree(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k], atol)
    else:
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


@pytest.mark.parametrize("routed", [False, True])
def test_lora_delta_matches_jax(routed):
    rng = np.random.default_rng(0)
    A, d, r, B, T = 3, 64, 8, 4, 5
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    la = (rng.standard_normal((A, d, r)) * 0.1).astype(np.float32)
    lb = (rng.standard_normal((A, r, d)) * 0.1).astype(np.float32)
    idx = np.asarray([2, 0, 1, 2], np.int32) if routed else None
    want = jw.lora_delta(jnp.asarray(x), jnp.asarray(la), jnp.asarray(lb),
                         jw.LoraCtx(None if idx is None else jnp.asarray(idx), 2.0), 0)
    ctx = tw.lora_ctx({"q": {"a": t(la)[None], "b": t(lb)[None]}},
                      None if idx is None else t(idx), 2.0, torch.float32)
    got = tw.lora_delta(t(x), t(la), t(lb), ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    if routed:   # masked-dense == each row through its own adapter alone
        for b in range(B):
            one = tw.lora_delta(t(x)[b:b + 1], t(la)[idx[b]:idx[b] + 1],
                                t(lb)[idx[b]:idx[b] + 1], tw.LoraCtx(None, 2.0))
            np.testing.assert_allclose(got[b:b + 1].numpy(), one.numpy(), atol=1e-5)


def test_init_slice_and_count_follow_jax():
    lcfg = tlora.LoraConfig(r=4, alpha=8, target_modules=("q_proj", "out_proj"))
    bank = tlora.init_lora(torch.Generator().manual_seed(0), CFG, lcfg, num_adapters=3)
    jbank = jlora.init_lora(jax.random.PRNGKey(0), CFG, jlora.LoraConfig(
        r=4, alpha=8, target_modules=("q_proj", "out_proj")), num_adapters=3)
    assert jax.tree.map(lambda x: x.shape, jbank) == \
        tlora.map_with_path(lambda _, x: tuple(x.shape), bank)
    assert tlora.num_adapters(bank) == 3 and tlora.rank(bank) == 4
    assert not any(e["b"].any() for side in bank.values() for e in side.values())
    one = tlora.slice_adapter(bank, 2)
    assert tlora.num_adapters(one) == 1
    assert torch.equal(one["encoder"]["q"]["a"][:, 0], bank["encoder"]["q"]["a"][:, 2])
    with pytest.raises(ValueError):
        tlora.init_lora(torch.Generator(), CFG, tlora.LoraConfig(target_modules=("fc1",)))


def test_stack_mixed_ranks_and_merge_match_jax():
    jb4, tb4 = random_bank(CFG, 1, 4, seed=1)
    jb8, tb8 = random_bank(CFG, 1, 8, seed=2)
    want = jlora.stack_adapters([jb4, jb8])
    got = tlora.stack_adapters([tb4, tb8])
    assert tlora.rank(got) == 8 and tlora.num_adapters(got) == 2
    _assert_trees_equal(got, want)

    jp, tp = jax_whisper(CFG)
    lcfg = jlora.LoraConfig(r=8, alpha=16)
    merged_j = jlora.merge_lora(jp, want, lcfg, adapter_index=1)
    merged_t = tlora.merge_lora(tp, got, tlora.LoraConfig(r=8, alpha=16),
                                adapter_index=1)
    for side, hooks in got.items():
        for hook in hooks:
            np.testing.assert_allclose(
                merged_t[side]["layers"][hook]["w"].numpy(),
                np.asarray(merged_j[side]["layers"][hook]["w"]), atol=1e-6, rtol=0)
    # The input params are left as they were.
    np.testing.assert_array_equal(tp["encoder"]["layers"]["q"]["w"].numpy(),
                                  np.asarray(jp["encoder"]["layers"]["q"]["w"]))


@pytest.mark.parametrize("saved_by", ["sar_tpu", "sar_tpu_torch"])
def test_adapter_directories_load_across_packages(tmp_path, saved_by):
    jb, tb = random_bank(CFG, 2, 4, seed=3)
    if saved_by == "sar_tpu":
        jlora.save_adapter(tmp_path / "a", jb, jlora.LoraConfig(r=4, alpha=8),
                           metadata={"languages": ["x", "y"]})
        bank, lcfg, meta = tlora.load_adapter(tmp_path / "a")
        assert isinstance(lcfg, tlora.LoraConfig)
    else:
        tlora.save_adapter(tmp_path / "a", tb, tlora.LoraConfig(r=4, alpha=8),
                           metadata={"languages": ["x", "y"]})
        bank, lcfg, meta = jlora.load_adapter(tmp_path / "a")
    assert (lcfg.r, lcfg.alpha, meta) == (4, 8, {"languages": ["x", "y"]})
    _assert_trees_equal(bank, jb)
    # load_any_adapter on a non-PEFT directory is load_adapter.
    again, _, _ = tlora.load_any_adapter(tmp_path / "a", CFG)
    _assert_trees_equal(again, jb)


def _peft_state_dict(rng, r=4):
    """PEFT-named lora_A [r, d_in] / lora_B [d_out, r] tensors, some layers
    of q_proj (both stacks) and the decoder's encoder_attn v_proj."""
    d = CFG.d_model
    sd = {"base_model.model.model.encoder.layers.0.self_attn.q_proj.weight":
          torch.zeros(d, d)}
    for side, attn, target, layers in (("encoder", "self_attn", "q_proj", (0, 1)),
                                       ("decoder", "self_attn", "q_proj", (1,)),
                                       ("decoder", "encoder_attn", "v_proj", (0, 1))):
        for l in layers:
            pre = f"base_model.model.model.{side}.layers.{l}.{attn}.{target}"
            sd[f"{pre}.lora_A.default.weight"] = torch.from_numpy(
                rng.standard_normal((r, d)).astype(np.float32))
            sd[f"{pre}.lora_B.default.weight"] = torch.from_numpy(
                rng.standard_normal((d, r)).astype(np.float32))
    return sd


def test_peft_state_dict_imports_like_jax(tmp_path):
    sd = _peft_state_dict(np.random.default_rng(4))
    want = jconvert.lora_from_peft_state_dict(sd, CFG)
    got = tconvert.lora_from_peft_state_dict(sd, CFG)
    _assert_trees_equal(got, want)
    assert not got["decoder"]["self_q"]["a"][0].any()      # layer 0 never named

    # A save_pretrained directory with the legacy .bin loads through
    # load_any_adapter, with PEFT's r and alpha.
    d = tmp_path / "peft"
    d.mkdir()
    (d / "adapter_config.json").write_text(
        '{"peft_type": "LORA", "r": 4, "lora_alpha": 8, "lora_dropout": 0.0, '
        '"target_modules": ["v_proj", "q_proj"]}')
    torch.save(sd, d / "adapter_model.bin")
    assert tconvert.is_peft_checkpoint(d) and not tconvert.is_peft_checkpoint(tmp_path)
    bank, lcfg, meta = tlora.load_any_adapter(d, CFG)
    assert meta == {"format": "peft"} and lcfg.scale == 2.0
    assert lcfg.target_modules == ("q_proj", "v_proj")
    _assert_trees_equal(bank, want)
    with pytest.raises(ValueError, match="no PEFT"):
        tconvert.lora_from_peft_state_dict({"x.weight": torch.zeros(1)}, CFG)
