"""Port K2 plain version (fused_kv_init_reference) against the JAX fused
kernel in interpret mode and against init_cache(head_minor=True)'s jnp
body, fp32 on the CPU, at the smallest shape the JAX kernel takes
(d_model 128, 2 heads of 64).

int8 values must be equal except |d| <= 1 on at most 0.1% of entries (the
frameworks sum the GEMM in another order, so a value on a .5 boundary may
round either way); scales within rtol 1e-6; pad rows 0 with scale 0."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import t

from sar_tpu.models import whisper as jw
from sar_tpu.ops.kv_init import fused_kv_init as jax_kv_init
from sar_tpu_torch.ops import kv_init

L, B, H, hd, S, S_pad = 2, 2, 2, 64, 100, 128
D = H * hd


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    enc = (rng.standard_normal((B, S_pad, D)) * 0.3).astype(np.float32)
    enc[:, S:] = 0.0
    wk = (rng.standard_normal((L, D, D)) * 0.05).astype(np.float32)
    wv = (rng.standard_normal((L, D, D)) * 0.05).astype(np.float32)
    bv = (rng.standard_normal((L, D)) * 0.05).astype(np.float32)
    got = kv_init.fused_kv_init_reference(t(enc), t(wk), t(wv), t(bv),
                                          n_heads=H, t_valid=S)
    return (enc, wk, wv, bv), [x.numpy() for x in got]


def _assert_k2_rules(got, want):
    kq, ks, vq, vs = got
    wkq, wks, wvq, wvs = (np.asarray(x) for x in want)
    assert kq.shape == (L, B, S_pad, D) and kq.dtype == np.int8
    assert ks.shape == (L, B, H, S_pad) and ks.dtype == np.float32
    for a, b in ((kq, wkq), (vq, wvq)):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 1 and (d != 0).mean() <= 1e-3
    np.testing.assert_allclose(ks, wks, rtol=1e-6, atol=0)
    np.testing.assert_allclose(vs, wvs, rtol=1e-6, atol=0)


def test_reference_matches_jax_kernel_interpret(data):
    (enc, wk, wv, bv), got = data
    want = jax_kv_init(jnp.asarray(enc), jnp.asarray(wk), jnp.asarray(wv),
                       jnp.asarray(bv), n_heads=H, t_valid=S, interpret=True)
    _assert_k2_rules(got, want)


def test_reference_matches_init_cache_jnp_body(data):
    """init_cache(head_minor=True) on the CPU runs the jnp scan body (the
    projections + whisper.quantize_kv) and pads the layout itself."""
    (enc, wk, wv, bv), got = data
    params = {"decoder": {"layers": {
        "cross_k": {"w": jnp.asarray(wk)},
        "cross_v": {"w": jnp.asarray(wv), "b": jnp.asarray(bv)}}}}
    cfg = type("Cfg", (), {"decoder_heads": H, "d_model": D})()
    cache = jw.init_cache(params, jnp.asarray(enc[:, :S]), cfg, max_len=8,
                          cross_kv_int8=True, self_kv_int8=True, head_minor=True)
    _assert_k2_rules(got, (cache.cross_k, cache.cross_k_scale,
                           cache.cross_v, cache.cross_v_scale))


def test_pad_rows_are_zero_with_scale_zero(data):
    _, (kq, ks, vq, vs) = data
    assert not kq[:, :, S:].any() and not vq[:, :, S:].any()
    assert not ks[..., S:].any() and not vs[..., S:].any()
    assert (ks[..., :S] > 0).all() and (vs[..., :S] > 0).all()


def test_quantize_rows_matches_whisper_quantize_kv():
    rng = np.random.default_rng(4)
    y = rng.standard_normal((B, S_pad, D)).astype(np.float32)
    y[0, 3, :hd] = 0.0                                   # an all-zero (row, head)
    q, s = kv_init.quantize_rows(t(y), H, S_pad)
    wq, ws = jw.quantize_kv(jnp.asarray(y).reshape(B, S_pad, H, hd))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq).reshape(B, S_pad, D))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws).transpose(0, 2, 1))


def test_cpu_dispatch_takes_the_plain_version(data):
    (enc, wk, wv, bv), got = data
    before = kv_init.LAUNCHES
    out = kv_init.fused_kv_init(t(enc), t(wk), t(wv), t(bv), n_heads=H, t_valid=S)
    for a, b in zip(out, got):
        np.testing.assert_array_equal(a.numpy(), b)
    assert kv_init.LAUNCHES == before
    meta = torch.empty((1, 64, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kv_init.fused_kv_init(meta, meta[None], meta[None], meta[:, 0], n_heads=1, t_valid=1)


def _kernel_configs() -> list[tuple[int, int, int]]:
    """csrc/kv_init.cu's kKvConfigs table, {rows, heads, stages} in order."""
    text = (Path(kv_init.__file__).resolve().parent.parent / "csrc" / "kv_init.cu").read_text()
    table = text[text.index("kKvConfigs[] = {"):]
    table = table[:table.index("};")]
    return [tuple(int(v) for v in m) for m in re.findall(r"\{(\d+), (\d+), (\d+)\}", table)]


def test_configurations_match_the_kernel():
    assert _kernel_configs() == list(kv_init.KV_CONFIGS)


@pytest.mark.parametrize("D_", [384, 512, 768, 1024, 1280])
def test_every_whisper_width_takes_the_128_row_configuration(D_):
    """whisper tiny .. large-v3 at whisper's S_pad of 1536: 128-row blocks of
    8 warps, 56,832 bytes of shared memory (two blocks per SM); an S_pad
    that is a multiple of 64 but not of 128 takes the 64-row one."""
    H_ = D_ // 64
    c = kv_init.kv_config(1536, H_)
    assert c == (128, 1, 3)
    assert kv_init.kv_shared_bytes(c) == 2 * 3 * (128 * 40 + 32 * 136) == 56_832
    assert kv_init.kv_config(1600, H_) == (64, 1, 3)
    assert kv_init.kv_config(64, H_) == (64, 1, 3)


@pytest.mark.parametrize("S_", [32, 100, 1500])
def test_s_pad_off_the_64_row_grid_is_refused(S_):
    assert kv_init.kv_config(S_, 12) is None
