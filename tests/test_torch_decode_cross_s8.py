"""Port K7 plain version (cross_decode_reference: s8 query and re-quantized
probabilities over the int8 head-minor cache) against the JAX s8 decode
kernel in interpret mode and against its jnp reference, fp32 on the CPU
within 2e-5 (the tolerance of tests/test_decode_cross.py): greedy q [B, D]
and beam-folded q [B, K, D] for K in {2, 4}, both layers of a stacked
cache, d_model 128 with 2 heads of 64, a full encoder (S=100 in S_pad=128)
and a short one (S=40). Also: the padding is masked on the scales, the CPU
dispatch takes the plain version, and the integer sums are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import t

from sar_tpu.models import whisper as jw
from sar_tpu.ops.decode_cross import cross_decode_attention as jax_s8
from sar_tpu.ops.decode_cross import cross_decode_reference as jax_reference
from sar_tpu_torch.ops import decode_cross

L, B, H, hd, S_pad = 2, 3, 2, 64, 128
D = H * hd


def _data(K, S, seed=31):
    """(qq, qs, kq, ks, vq, vs) as numpy, quantized by the JAX package:
    qq [B, D] with qs [B, H, 1] for K=1, else [B, K, D] with [B, K*H, 1]."""
    rng = np.random.default_rng(seed + 10 * K + S)
    k = rng.standard_normal((L, B, S_pad, H, hd)).astype(np.float32)
    v = rng.standard_normal((L, B, S_pad, H, hd)).astype(np.float32)
    kq, ks = jw.quantize_kv(jnp.asarray(k))
    vq, vs = jw.quantize_kv(jnp.asarray(v))
    ks = ks.transpose(0, 1, 3, 2).at[..., S:].set(0.0)   # [L, B, H, S_pad]
    vs = vs.transpose(0, 1, 3, 2).at[..., S:].set(0.0)
    q = rng.standard_normal((B, K, H, hd)).astype(np.float32) * hd ** -0.5
    qq, qs = jw.quantize_kv(jnp.asarray(q))                # [B, K, H, hd], [B, K, H]
    qq = qq.reshape(B, K * D) if K == 1 else qq.reshape(B, K, D)
    return [np.asarray(x) for x in (qq, qs.reshape(B, K * H, 1), kq.reshape(L, B, S_pad, D),
                                    ks, vq.reshape(L, B, S_pad, D), vs)]


@pytest.mark.parametrize("S", [100, 40], ids=["S100", "short-S40"])
@pytest.mark.parametrize("jax_side", ["kernel_interpret", "jnp_reference"])
@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_s8_reference_matches_jax(K, layer, jax_side, S):
    data = _data(K, S)
    args = [jnp.asarray(x) for x in data]
    if jax_side == "kernel_interpret":
        want = jax_s8(*args, layer=layer, n_heads=H, out_dtype=jnp.float32,
                      interpret=True, beam_width=K)
    else:
        want = jax_reference(*args, layer=layer, n_heads=H, out_dtype=jnp.float32)
    got = decode_cross.cross_decode_reference(*(t(x) for x in data), layer=layer,
                                              n_heads=H, out_dtype=torch.float32)
    assert got.shape == data[0].shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_s8_padding_is_masked_and_cpu_takes_the_plain_version():
    """Garbage in rows whose key scale is 0 must not reach the output; on
    CPU tensors the wrapper is the plain version and counts no launch."""
    qq, qs, kq, ks, vq, vs = (t(x) for x in _data(2, 40))
    kq2, vq2 = kq.clone(), vq.clone()
    kq2[:, :, 40:] = 127
    vq2[:, :, 40:] = -127
    before = (decode_cross.S8_LAUNCHES, decode_cross.S8_BEAM_LAUNCHES)
    a = decode_cross.cross_decode_attention(qq, qs, kq, ks, vq, vs, layer=1, n_heads=H)
    b = decode_cross.cross_decode_reference(qq, qs, kq2, ks, vq2, vs, layer=1, n_heads=H)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert (decode_cross.S8_LAUNCHES, decode_cross.S8_BEAM_LAUNCHES) == before


def test_each_beam_equals_its_own_greedy_call():
    """Folding is only a batching: beam k of sample b is the [B, D] call on
    that beam's query and scales."""
    qq, qs, kq, ks, vq, vs = (t(x) for x in _data(4, 100))
    folded = decode_cross.cross_decode_reference(qq, qs, kq, ks, vq, vs, layer=0,
                                                 n_heads=H, out_dtype=torch.float32)
    for k in range(4):
        one = decode_cross.cross_decode_reference(
            qq[:, k].contiguous(), qs[:, k * H:(k + 1) * H].contiguous(), kq, ks, vq, vs,
            layer=0, n_heads=H, out_dtype=torch.float32)
        assert torch.equal(folded[:, k], one)


def test_integer_sums_are_exact_at_whisper_small_length():
    """P.V over S_pad=1536 rows reaches 1536 x 127 x 127 = 2.5e7 > 2^24: the
    plain version's sums equal int64 sums rounded once to fp32."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.integers(-127, 128, size=(2, 3, 1536), dtype=np.int8))
    b = torch.from_numpy(rng.integers(100, 128, size=(2, 1536, 64), dtype=np.int8))
    a[0] = 127
    b[0] = 127
    got = decode_cross.int_einsum("bqs,bsd->bqd", a, b)
    want = torch.einsum("bqs,bsd->bqd", a.long(), b.long())
    assert int(want[0].max()) == 1536 * 127 * 127 > 2 ** 24
    assert torch.equal(got, want.double().float())


@pytest.mark.parametrize("K,S_,ok", [(1, 1536, True), (4, 1536, True), (8, 1536, True),
                                     (8, 5760, True), (8, 5824, False)])
def test_s8_shared_memory_bound(K, S_, ok):
    """K7 keeps K rows of S_pad fp32 scores and K rows of s8 probabilities;
    the wrapper refuses what does not fit one block, before any launch."""
    assert (decode_cross.s8_shared_bytes(K, S_) <= decode_cross.S8_MAX_SHARED_BYTES) == ok
    assert decode_cross.s8_shared_bytes(2, 64) == 4 * 2 * 8 * 64 + 2 * 64
