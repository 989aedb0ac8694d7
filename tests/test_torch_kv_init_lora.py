"""K4, the LoRA variant of the fused cross-KV init, on the CPU: the port's
plain version (fused_kv_init_reference with va/vb) against the JAX Pallas
kernel in interpret mode, and the port's init_cache against JAX
init_cache(head_minor=True, lora=, adapter_idx=), fp32, at the smallest
shape the JAX kernel takes (d_model 128, 2 heads of 64). Both forms: one
adapter slice per sample, and one slice broadcast over the batch.

Rules, as tests/test_kv_init.py's: int8 values equal except |d| <= 1 on at
most 0.1% of entries (the GEMMs sum in another order, so a value on a .5
boundary may round either way); scales within rtol 1e-5; pad rows 0 with
scale 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import get_config, random_bank, t, to_numpy

from sar_tpu.models import whisper as jw
from sar_tpu.ops.kv_init import fused_kv_init as jax_kv_init
from sar_tpu_torch.models import whisper as tw
from sar_tpu_torch.models.convert import from_jax_params
from sar_tpu_torch.ops import kv_init

L, B, H, hd, S, S_pad, r = 2, 3, 2, 64, 100, 128, 8
D = H * hd


def _assert_k4_rules(got, want, t_valid=S):
    kq, ks, vq, vs = (np.asarray(x) for x in got)
    wkq, wks, wvq, wvs = (np.asarray(x) for x in want)
    assert kq.shape == wkq.shape and kq.dtype == np.int8
    for a, b in ((kq, wkq), (vq, wvq)):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 1 and (d != 0).mean() <= 1e-3
        assert not a[:, :, t_valid:].any()
    for a, b in ((ks, wks), (vs, wvs)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
        assert not a[..., t_valid:].any() and (a[..., :t_valid] > 0).all()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    enc = (rng.standard_normal((B, S_pad, D)) * 0.3).astype(np.float32)
    enc[:, S:] = 0.0
    wk, wv = ((rng.standard_normal((L, D, D)) * 0.05).astype(np.float32) for _ in range(2))
    bv = (rng.standard_normal((L, D)) * 0.05).astype(np.float32)
    a = (rng.standard_normal((L, 4, D, r)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((L, 4, r, D)) * 0.1).astype(np.float32)
    return enc, wk, wv, bv, a, b


def _slices(a, b, shared):
    idx = np.asarray([2, 0, 3])
    return (a[:, :1], b[:, :1]) if shared else (a[:, idx], b[:, idx])


@pytest.mark.parametrize("shared", [False, True])
def test_reference_matches_jax_lora_kernel_interpret(data, shared):
    enc, wk, wv, bv, a, b = data
    va, vb = _slices(a, b, shared)
    want = jax_kv_init(*(jnp.asarray(x) for x in (enc, wk, wv, bv)), n_heads=H,
                       t_valid=S, va=jnp.asarray(va), vb=jnp.asarray(vb),
                       lora_scale=2.0, interpret=True)
    n2, n4 = kv_init.LAUNCHES, kv_init.LORA_LAUNCHES
    got = kv_init.fused_kv_init(*(t(x) for x in (enc, wk, wv, bv)), n_heads=H,
                                t_valid=S, va=t(va), vb=t(vb), lora_scale=2.0)
    assert (kv_init.LAUNCHES, kv_init.LORA_LAUNCHES) == (n2, n4)   # CPU: plain
    _assert_k4_rules(got, want)
    # The LoRA term is there: the unadapted V differs, K does not.
    plain = kv_init.fused_kv_init_reference(*(t(x) for x in (enc, wk, wv, bv)),
                                            n_heads=H, t_valid=S)
    assert torch.equal(plain[0], got[0]) and not torch.equal(plain[2], got[2])


def test_zero_padded_rank_leaves_the_result_unchanged(data):
    """The CUDA wrapper pads r to the kernel's granule of 16; the padded
    slices give the same cache."""
    enc, wk, wv, bv, a, b = data
    va, vb = (t(x) for x in _slices(a, b, False))
    pva, pvb, Bv, rp = kv_init._lora_slices("k4", va, vb, L, B, D)
    assert (Bv, rp) == (B, 16) and pva.shape[-1] == pvb.shape[-2] == 16
    args = [t(x) for x in (enc, wk, wv, bv)]
    want = kv_init.fused_kv_init_reference(*args, n_heads=H, t_valid=S, va=va, vb=vb)
    got = kv_init.fused_kv_init_reference(*args, n_heads=H, t_valid=S, va=pva, vb=pvb)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="ranks"):
        kv_init._lora_slices("k4", torch.zeros(L, B, D, 65), torch.zeros(L, B, 65, D),
                             L, B, D)
    with pytest.raises(ValueError, match="B|1"):
        kv_init._lora_slices("k4", va[:, :2], vb[:, :2], L, B, D)


@pytest.fixture(scope="module")
def model():
    """The smallest kernel-legal Whisper (d_model 128, 2 heads of 64)."""
    cfg = dataclasses.replace(get_config("whisper-test"), name="kv-init-test",
                              d_model=128, encoder_heads=2, decoder_heads=2)
    jp = jw.init_params(jax.random.PRNGKey(0), cfg)
    enc = np.random.default_rng(5).standard_normal(
        (B, cfg.max_source_positions, cfg.d_model)).astype(np.float32)
    return cfg, jp, from_jax_params(to_numpy(jp)), enc


@pytest.mark.parametrize("targets,per_sample", [
    (("q_proj", "v_proj"), True),     # K4, one slice per sample
    (("q_proj", "v_proj"), False),    # K4, one adapter broadcast
    (("k_proj", "v_proj"), True),     # cross_k adapted: the torch body
])
def test_init_cache_matches_jax(model, targets, per_sample, monkeypatch):
    cfg, jp, tp, enc = model
    jb, tb = random_bank(cfg, 4, r, seed=7, targets=targets)
    calls = []
    real = tw.fused_kv_init
    monkeypatch.setattr(tw, "fused_kv_init",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    idx = np.asarray([1, 3, 0], np.int32) if per_sample else None
    want = jw.init_cache(jp, jnp.asarray(enc), cfg, max_len=8, lora=jb,
                         adapter_idx=None if idx is None else jnp.asarray(idx),
                         lora_scale=2.0, cross_kv_int8=True, self_kv_int8=True,
                         head_minor=True)
    got = tw.init_cache(tp, t(enc), cfg, max_len=8, lora=tb,
                        adapter_idx=None if idx is None else t(idx), lora_scale=2.0,
                        cross_kv_int8=True, self_kv_int8=True)
    _assert_k4_rules((got.cross_k, got.cross_k_scale, got.cross_v, got.cross_v_scale),
                     (want.cross_k, want.cross_k_scale, want.cross_v, want.cross_v_scale),
                     t_valid=cfg.max_source_positions)
    # The bank's contents pick the path: K4 (with the slices) for a cross_v
    # bank, the torch projections for one that adapts cross_k.
    if "k_proj" in targets:
        assert calls == []
    else:
        (kw,) = calls
        assert kw["va"].shape == (cfg.decoder_layers, B if per_sample else 1,
                                  cfg.d_model, r)


@pytest.mark.parametrize("D_", [384, 512, 768, 1024, 1280])
@pytest.mark.parametrize("rank", [16, 32, 48, 64])
def test_every_width_and_padded_rank_has_a_configuration(D_, rank):
    """K4 takes the padded ranks 16..64 at every Whisper width: vb's rows of
    the block's head and u's rows of the block stay resident beside K2's
    ring (84,480 bytes at rank 64: two blocks per SM)."""
    c = kv_init.kv_config(1536, D_ // 64, rank)
    assert c == (128, 1, 3)
    want = 2 * (3 * (128 * 40 + 32 * 136) + rank * 72 + 128 * (rank + 8))
    assert kv_init.kv_shared_bytes(c, rank) == want <= kv_init.MAX_SHARED_BYTES


def test_ranks_past_the_kernel_are_refused_before_padding():
    va = torch.zeros((L, 1, D, 65))
    vb = torch.zeros((L, 1, 65, D))
    with pytest.raises(ValueError, match="ranks 1..64"):
        kv_init._lora_slices("K4", va, vb, L, B, D)
    va8, vb8, Bv, rp = kv_init._lora_slices("K4", va[..., :8], vb[:, :, :8], L, B, D)
    assert (Bv, rp) == (1, 16) and va8.shape[-1] == 16 and vb8.shape[2] == 16
