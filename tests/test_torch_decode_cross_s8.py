"""Port K7 plain version (cross_decode_reference: s8 query and re-quantized
probabilities over the int8 head-minor cache) against the JAX s8 decode
kernel in interpret mode and against its jnp reference, fp32 on the CPU
within 2e-5 (the tolerance of tests/test_decode_cross.py): greedy q [B, D]
and beam-folded q [B, K, D] for K in {2, 4}, both layers of a stacked
cache, d_model 128 with 2 heads of 64, a full encoder (S=100 in S_pad=128)
and a short one (S=40). Also: the padding is masked on the scales, the CPU
dispatch takes the plain version, the integer sums are exact, and the
Python mirror of the kernel's cluster split and shared memory."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import t

from sar_tpu.models import whisper as jw
from sar_tpu.ops.decode_cross import cross_decode_attention as jax_s8
from sar_tpu.ops.decode_cross import cross_decode_reference as jax_reference
from sar_tpu_torch.ops import decode_cross
from sar_tpu_torch.ops.attic import decode_self

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
                                     (8, 24320, True), (8, 24384, False)])
def test_s8_shared_memory_bound(K, S_, ok):
    """K7 keeps, per block of its cluster split, the v ring, K rows of the
    slice's fp32 scores, its fp32 v scales, K rows of s8 probabilities
    (whole 32-row steps plus 16 bytes) and the C blocks' int32 [K][64]
    partials; the wrapper refuses what does not fit one block, before any
    launch."""
    assert (decode_cross.s8_shared_bytes(K, S_) <= decode_cross.MAX_SHARED_BYTES) == ok
    assert decode_cross.s8_shared_bytes(2, 64) == (128 * 64 + 4 * 3 * 64 + 2 * (64 + 16)
                                                   + 4 * 1 * 2 * 64)


CSRC = Path(decode_cross.__file__).resolve().parent.parent / "csrc"


def test_s8_split_constants_match_the_kernel():
    text = (CSRC / "decode_s8.cu").read_text()
    c = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    d = {m[0]: int(m[1]) for m in re.findall(r"#define (SAR_S8_\w+) (\d+)", text)}
    assert d["SAR_S8_CROSS_MIN_SLICE"] == decode_cross.S8_MIN_SLICE
    assert d["SAR_S8_SELF_MIN_SLICE"] == decode_self.MIN_SLICE
    assert d["SAR_S8_THREADS"] == decode_cross.S8_THREADS
    assert "constexpr int STAGE_ROWS = NW * KSTEP / 2;" in text
    assert c["MAX_CLUSTER"] == decode_cross.MAX_CLUSTER
    assert c["RING_ROWS"] == decode_cross.S8_RING_ROWS
    assert c["KSTEP"] == decode_cross.S8_KSTEP
    assert c["MAX_BEAMS"] == decode_cross.S8_BEAM_WIDTHS.stop - 1


@pytest.mark.parametrize("S_,want", [(64, (1, 64)), (512, (1, 512)), (576, (2, 288)),
                                     (1536, (3, 512)), (2048, (4, 512)), (27328, (8, 3416))])
def test_s8_cluster_split_picks(S_, want):
    """C = ceil(S_pad / 512) blocks, at most 8; whisper's 1536 rows go to 3
    blocks of 512."""
    assert decode_cross.s8_cluster_split(S_) == want


def test_s8_cluster_split_covers_every_row_once():
    """K7 over every S_pad (multiples of 64), K9 over every max_len: each
    row in exactly one block's slice, and no block without rows."""
    cases = [(S_, decode_cross.S8_MIN_SLICE) for S_ in range(64, 40_000, 64)]
    cases += [(S_, decode_self.MIN_SLICE) for S_ in range(1, 5000)]
    for S_, min_slice in cases:
        C, rows = decode_cross.s8_cluster_split(S_, min_slice)
        assert 1 <= C <= decode_cross.MAX_CLUSTER
        covered = [s for r in range(C) for s in range(r * rows, min(S_, (r + 1) * rows))]
        assert covered == list(range(S_)), S_
        assert (C - 1) * rows < S_, S_


def test_every_shape_the_single_block_kernel_took_is_taken():
    """The single-block K7 took K rows of max(S_pad, 512) fp32 scores and
    K rows of s8 probabilities in 227 KB less 256 bytes; the cluster split
    takes all of them at every K."""
    for K in decode_cross.S8_BEAM_WIDTHS:
        took = [S_ for S_ in range(64, 70_000, 64)
                if 4 * K * max(S_, 512) + K * S_ <= 232_448 - 256]
        assert took and all(decode_cross.s8_shared_bytes(K, S_) <= decode_cross.MAX_SHARED_BYTES
                            for S_ in took)


def test_sweep_variants_override_the_kernels_defines():
    """csrc/decode_s8.cu's design choices are `#define SAR_S8_*` defaults
    that a build may override with -D: the slices and the threads are the
    Python mirror's, and both products' tensor-core thresholds are there."""
    import re

    from sar_tpu_torch.ops import _build
    text = (_build.CSRC / "decode_s8.cu").read_text()
    defaults = {m[0]: int(m[1]) for m in re.findall(r"#define SAR_S8_(\w+) (\d+)", text)}
    assert defaults["CROSS_MIN_SLICE"] == decode_cross.S8_MIN_SLICE
    assert defaults["SELF_MIN_SLICE"] == decode_self.MIN_SLICE
    assert defaults["THREADS"] == decode_cross.S8_THREADS
    assert {"QK_MMA_FROM", "PV_MMA_FROM", "LOADS"} <= set(defaults)
