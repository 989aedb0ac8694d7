"""K9's plain version (sar_tpu_torch/ops/attic/decode_self.py) against the
JAX package's parked s8 self-attention decode kernel run in Pallas
interpret mode and against its jnp reference, at tests/test_decode_self.py's
shapes, layers and valid lengths, fp32 on the CPU within 2e-5 (that test's
tolerance: the integer sums are exact, the fp32 softmax sums in another
order). Also the valid length as a 0-d tensor, CPU dispatch without a
launch, a tensor on a device with no kernel raising, whisper's max_len at
n = 0 and at an n inside a slice, and the Python mirror of the kernel's
cluster split and shared memory."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import t

from sar_tpu.models import whisper as jw
from sar_tpu.ops.attic.decode_self import self_decode_attention as jax_kernel
from sar_tpu.ops.attic.decode_self import self_decode_reference as jax_reference
from sar_tpu_torch.ops.attic import decode_self

L, B, H, hd, MAX = 2, 6, 4, 64, 40
D = H * hd
TOL = 2e-5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    k = rng.standard_normal((L, B, MAX, H, hd)).astype(np.float32)
    v = rng.standard_normal((L, B, MAX, H, hd)).astype(np.float32)
    kq, ks = jw.quantize_kv(jnp.asarray(k))
    vq, vs = jw.quantize_kv(jnp.asarray(v))
    qq, qs = jw.quantize_kv(jnp.asarray(rng.standard_normal((B, H, 1, hd)), jnp.float32))
    return [np.asarray(a) for a in (qq[:, :, 0].reshape(B, D), qs, kq.reshape(L, B, MAX, D),
                                    ks.transpose(0, 1, 3, 2), vq.reshape(L, B, MAX, D),
                                    vs.transpose(0, 1, 3, 2))]


@pytest.mark.parametrize("layer,valid", [(0, 7), (1, MAX), (0, 1), (1, 23)])
@pytest.mark.parametrize("against", ["kernel", "reference"])
def test_plain_version_matches_jax(data, layer, valid, against):
    args = [jnp.asarray(a) for a in data]
    if against == "kernel":
        want = jax_kernel(*args, jnp.int32(valid), layer=layer, n_heads=H,
                          out_dtype=jnp.float32, interpret=True)
    else:
        want = jax_reference(*args, valid, layer=layer, n_heads=H, out_dtype=jnp.float32)
    got = decode_self.self_decode_attention(*(t(a) for a in data), valid, layer=layer,
                                            n_heads=H, out_dtype=torch.float32)
    assert got.shape == (B, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_valid_length_as_a_tensor_and_the_masked_tail(data):
    qq, qs, kq, ks, vq, vs = (t(a) for a in data)
    a = decode_self.self_decode_reference(qq, qs, kq, ks, vq, vs, 9, layer=1, n_heads=H)
    b = decode_self.self_decode_reference(qq, qs, kq, ks, vq, vs,
                                          torch.tensor(9, dtype=torch.int32), layer=1,
                                          n_heads=H)
    assert torch.equal(a, b) and a.dtype == torch.bfloat16
    kq2, vq2 = kq.clone(), vq.clone()
    kq2[:, :, 9:], vq2[:, :, 9:] = 127, -127            # rows >= valid_len
    c = decode_self.self_decode_reference(qq, qs, kq2, ks, vq2, vs, 9, layer=1, n_heads=H)
    assert torch.equal(a, c)


def test_cpu_dispatch_and_refusals(data):
    args = [t(a) for a in data]
    n = decode_self.LAUNCHES
    decode_self.self_decode_attention(*args, 5, layer=0, n_heads=H)
    assert decode_self.LAUNCHES == n
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        decode_self.self_decode_attention(*meta, 5, layer=0, n_heads=H)
    # One block of whisper's 448 rows split 2 ways: a two-stage v ring (256
    # rows), 224 fp32 scores and v scales, 224 + 16 s8 probabilities, and
    # the 2 blocks' int32 [1][64] partials.
    assert decode_self.shared_bytes(448) == 256 * 64 + 4 * 2 * 224 + 224 + 16 + 4 * 2 * 64


@pytest.mark.parametrize("S_,want", [(448, (2, 224)), (40, (1, 40)), (1, (1, 1)),
                                     (257, (2, 129)), (46_438, (8, 5805))])
def test_cluster_split_picks(S_, want):
    """K9 splits max_len into C = ceil(max_len / 256) blocks, at most 8:
    whisper's 448 rows go to 2 blocks of 224; a ragged 40 to one block."""
    assert decode_self.cluster_split(S_) == want
    assert decode_self.shared_bytes(S_) <= decode_self.MAX_SHARED_BYTES


def test_every_max_len_the_single_block_kernel_took_is_taken():
    """The single-block K9 took max(max_len, 512) fp32 scores and max_len s8
    probabilities in 227 KB less 256 bytes; the split takes them all."""
    took = [S_ for S_ in range(1, 50_000) if 4 * max(S_, 512) + S_ <= 232_448 - 256]
    assert took[-1] == 46_438
    assert all(decode_self.shared_bytes(S_) <= decode_self.MAX_SHARED_BYTES for S_ in took)


@pytest.mark.parametrize("valid", [0, 300], ids=["n0-uniform", "n-inside-a-slice"])
def test_plain_version_matches_jax_at_whisper_max_len(valid):
    """At max_len 448 (2 slices of 224): n = 0, where every row is masked and
    the softmax is uniform over all 448 rows, and n = 300, which ends inside
    the second slice."""
    rng = np.random.default_rng(12)
    L_, B_, H_, S_ = 1, 2, 2, 448
    D_ = H_ * hd
    kq, ks = jw.quantize_kv(jnp.asarray(rng.standard_normal((L_, B_, S_, H_, hd)), jnp.float32))
    vq, vs = jw.quantize_kv(jnp.asarray(rng.standard_normal((L_, B_, S_, H_, hd)), jnp.float32))
    qq, qs = jw.quantize_kv(jnp.asarray(rng.standard_normal((B_, H_, 1, hd)), jnp.float32))
    data = [np.asarray(a) for a in (qq[:, :, 0].reshape(B_, D_), qs, kq.reshape(L_, B_, S_, D_),
                                    ks.transpose(0, 1, 3, 2), vq.reshape(L_, B_, S_, D_),
                                    vs.transpose(0, 1, 3, 2))]
    want = jax_reference(*[jnp.asarray(a) for a in data], valid, layer=0, n_heads=H_,
                         out_dtype=jnp.float32)
    got = decode_self.self_decode_reference(*(t(a) for a in data), valid, layer=0, n_heads=H_,
                                            out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
