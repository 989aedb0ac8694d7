"""Port K3 plain version (cross_decode_reference_exact) against the JAX
exact cross-decode kernel in interpret mode and against its jnp reference,
fp32 on the CPU within 2e-5, for both layers of a stacked head-minor
cache."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import t

from sar_tpu.models import whisper as jw
from sar_tpu.ops.decode_cross import cross_decode_attention_exact as jax_exact
from sar_tpu.ops.decode_cross import cross_decode_reference_exact as jax_reference
from sar_tpu_torch.models import whisper as tw
from sar_tpu_torch.ops import decode_cross

L, B, H, hd, S, S_pad = 2, 3, 4, 64, 100, 128
D = H * hd


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    k = rng.standard_normal((L, B, S_pad, H, hd)).astype(np.float32)
    v = rng.standard_normal((L, B, S_pad, H, hd)).astype(np.float32)
    kq, ks = jw.quantize_kv(jnp.asarray(k))
    vq, vs = jw.quantize_kv(jnp.asarray(v))
    ks = ks.transpose(0, 1, 3, 2).at[..., S:].set(0.0)   # [L, B, H, S_pad]
    vs = vs.transpose(0, 1, 3, 2).at[..., S:].set(0.0)
    q = rng.standard_normal((B, D)).astype(np.float32) * hd ** -0.5
    return [np.asarray(x) for x in (q, kq.reshape(L, B, S_pad, D), ks,
                                    vq.reshape(L, B, S_pad, D), vs)]


@pytest.mark.parametrize("jax_side", ["kernel_interpret", "jnp_reference"])
@pytest.mark.parametrize("layer", [0, 1])
def test_reference_matches_jax(data, layer, jax_side):
    args = [jnp.asarray(x) for x in data]
    if jax_side == "kernel_interpret":
        want = jax_exact(*args, layer=layer, n_heads=H, out_dtype=jnp.float32,
                         interpret=True)
    else:
        want = jax_reference(*args, layer=layer, n_heads=H, out_dtype=jnp.float32)
    got = decode_cross.cross_decode_reference_exact(
        *(t(x) for x in data), layer=layer, n_heads=H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_padding_is_masked_on_the_scales(data):
    """Garbage in rows whose key scale is 0 must not reach the output."""
    q, kq, ks, vq, vs = (t(x) for x in data)
    kq2, vq2 = kq.clone(), vq.clone()
    kq2[:, :, S:] = 127
    vq2[:, :, S:] = -127
    a = decode_cross.cross_decode_reference_exact(q, kq, ks, vq, vs, layer=1, n_heads=H)
    b = decode_cross.cross_decode_reference_exact(q, kq2, ks, vq2, vs, layer=1, n_heads=H)
    assert torch.equal(a, b)


def test_quantize_kv_matches_whisper():
    x = np.random.default_rng(3).standard_normal((2, 3, 5, hd)).astype(np.float32)
    x[0, 0, 0] = 0.0
    q, s = tw.quantize_kv(t(x))
    wq, ws = jw.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))


def test_cpu_dispatch_takes_the_plain_version(data):
    args = [t(x) for x in data]
    before = decode_cross.LAUNCHES
    got = decode_cross.cross_decode_attention_exact(*args, layer=1, n_heads=H)
    want = decode_cross.cross_decode_reference_exact(*args, layer=1, n_heads=H)
    assert torch.equal(got, want) and decode_cross.LAUNCHES == before
