"""Port K5 plain version (the beam-folded cross_decode_reference_exact, q
[B, K, D]) against the JAX exact cross-decode kernel with beam_width K in
interpret mode and against the JAX jnp reference, for K in {2, 4}, d_model
128 with 2 heads, an S_pad of 128 with 28 pad rows (scale 0), both layers
of a stacked head-minor cache: fp32 within 1e-5, bf16 within 2e-2 (the
bf16 rounding of the output and of the weighted probabilities, with sums
taken in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import t

from sar_tpu.models import whisper as jw
from sar_tpu.ops.decode_cross import cross_decode_attention_exact as jax_exact
from sar_tpu.ops.decode_cross import cross_decode_reference_exact as jax_reference
from sar_tpu_torch.ops import decode_cross

L, B, H, hd, S, S_pad = 2, 3, 2, 64, 100, 128
D = H * hd
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _data(K, seed=21):
    rng = np.random.default_rng(seed + K)
    k = rng.standard_normal((L, B, S_pad, H, hd)).astype(np.float32)
    v = rng.standard_normal((L, B, S_pad, H, hd)).astype(np.float32)
    kq, ks = jw.quantize_kv(jnp.asarray(k))
    vq, vs = jw.quantize_kv(jnp.asarray(v))
    ks = ks.transpose(0, 1, 3, 2).at[..., S:].set(0.0)   # [L, B, H, S_pad]
    vs = vs.transpose(0, 1, 3, 2).at[..., S:].set(0.0)
    q = rng.standard_normal((B, K, D)).astype(np.float32) * hd ** -0.5
    return [np.asarray(x) for x in (q, kq.reshape(L, B, S_pad, D), ks,
                                    vq.reshape(L, B, S_pad, D), vs)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_side", ["kernel_interpret", "jnp_reference"])
@pytest.mark.parametrize("K", [2, 4])
def test_beam_reference_matches_jax(K, jax_side, dtype):
    data = _data(K)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    # The same bf16-rounded q on both sides.
    q = np.asarray(jnp.asarray(data[0]).astype(jdt).astype(jnp.float32))
    args = [jnp.asarray(q).astype(jdt)] + [jnp.asarray(x) for x in data[1:]]
    targs = [t(q).to(tdt)] + [t(x) for x in data[1:]]
    for layer in range(L):
        if jax_side == "kernel_interpret":
            want = jax_exact(*args, layer=layer, n_heads=H, out_dtype=jnp.float32,
                             interpret=True, beam_width=K)
        else:
            want = jax_reference(*args, layer=layer, n_heads=H, out_dtype=jnp.float32)
        got = decode_cross.cross_decode_reference_exact(*targs, layer=layer, n_heads=H)
        assert got.shape == (B, K, D) and got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_each_beam_equals_its_own_greedy_call():
    """Folding is only a batching: beam k of sample b is the [B, D] call
    (K3's plain version) on that beam's queries."""
    q, kq, ks, vq, vs = (t(x) for x in _data(4))
    folded = decode_cross.cross_decode_reference_exact(q, kq, ks, vq, vs, layer=1, n_heads=H)
    for k in range(4):
        one = decode_cross.cross_decode_reference_exact(
            q[:, k].contiguous(), kq, ks, vq, vs, layer=1, n_heads=H)
        np.testing.assert_allclose(folded[:, k].numpy(), one.numpy(), rtol=1e-6, atol=1e-6)


def test_beam_padding_is_masked_and_cpu_takes_the_plain_version():
    q, kq, ks, vq, vs = (t(x) for x in _data(2))
    kq2, vq2 = kq.clone(), vq.clone()
    kq2[:, :, S:] = 127
    vq2[:, :, S:] = -127
    before = (decode_cross.LAUNCHES, decode_cross.BEAM_LAUNCHES)
    a = decode_cross.cross_decode_attention_exact(q, kq, ks, vq, vs, layer=0, n_heads=H)
    b = decode_cross.cross_decode_reference_exact(q, kq2, ks, vq2, vs, layer=0, n_heads=H)
    assert torch.equal(a, b)
    assert (decode_cross.LAUNCHES, decode_cross.BEAM_LAUNCHES) == before


@pytest.mark.parametrize("K,S_,ok", [(2, 1536, True), (8, 1536, True), (8, 7232, True),
                                     (8, 7296, False), (1, 1536, True)])
def test_beam_shared_memory_bound(K, S_, ok):
    """K5 keeps K rows of S_pad fp32 scores; the wrapper refuses what does
    not fit one block's 227 KB, before any launch."""
    assert (decode_cross.beam_shared_bytes(K, S_) <= decode_cross.MAX_SHARED_BYTES) == ok
    assert decode_cross.beam_shared_bytes(K, 64) == 4 * K * 8 * 64
