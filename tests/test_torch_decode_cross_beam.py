"""Port K5 plain version (the beam-folded cross_decode_reference_exact, q
[B, K, D]) against the JAX exact cross-decode kernel with beam_width K in
interpret mode and against the JAX jnp reference, for K in {2, 4}, d_model
128 with 2 heads, an S_pad of 128 with 28 pad rows (scale 0), both layers
of a stacked head-minor cache: fp32 within 1e-5, bf16 within 2e-2 (the
bf16 rounding of the output and of the weighted probabilities, with sums
taken in another order)."""

import re
from pathlib import Path

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
                                     (8, 7296, True), (8, 33408, True), (8, 33472, False),
                                     (1, 1536, True)])
def test_beam_shared_memory_bound(K, S_, ok):
    """K3/K5 keep a block's slice of the cluster split in shared memory (the
    int8 v ring, K rows of fp32 scores and the v scales); the wrapper
    refuses what does not fit before any launch. S_pad 7296, which the
    single-block kernel refused at K=8, is now taken."""
    assert (decode_cross.beam_shared_bytes(K, S_) <= decode_cross.MAX_SHARED_BYTES) == ok
    assert decode_cross.beam_shared_bytes(K, 64) == 64 * 64 + 4 * (K + 1) * 64


CSRC = Path(decode_cross.__file__).resolve().parent.parent / "csrc"


def _constants(name: str) -> dict:
    """The `constexpr int` constants of a kernel source."""
    text = (CSRC / name).read_text()
    return {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_split_constants_match_the_kernel():
    c = _constants("decode_cross.cu")
    assert c["MAX_CLUSTER"] == decode_cross.MAX_CLUSTER
    assert c["MIN_SLICE"] == decode_cross.MIN_SLICE
    assert c["NS"] == decode_cross.RING_STAGES
    assert c["MAX_BEAMS"] == decode_cross.KERNEL_BEAM_WIDTHS.stop - 1
    assert c["NT"] * 16 // c["HD"] == decode_cross.RING_ROWS
    assert 232_448 - 48 * 1024 == decode_cross.MAX_SHARED_BYTES


def test_stream_constants_match_the_kernel():
    """K3's large-batch form: the Python mirror's constants are the C
    source's."""
    c = _constants("decode_cross.cu")
    assert c["SR"] == decode_cross.STREAM_ROWS
    assert c["STREAM_HEADS"] == decode_cross.STREAM_HEADS
    assert c["STREAM_STAGES"] == decode_cross.STREAM_STAGES
    assert c["STREAM_WARPS"] == decode_cross.STREAM_WARPS
    assert c["STREAM_PAIRS_PER_SM"] == decode_cross.STREAM_PAIRS_PER_SM
    assert c["kMaxStreamSmem"] == decode_cross.MAX_STREAM_SHARED_BYTES


# The accepted cells' shapes take the large-batch form (small.eval.long,
# turbo.eval.short, owsm.eval.short); the routed service's batches of at
# most 8 keep the cluster form, as do whisper-tiny's 6 heads (no items of
# 4) and an S_pad whose scores no longer fit beside the ring.
@pytest.mark.parametrize("B,H,S_,want", [(128, 12, 1536, 4), (64, 20, 1536, 4),
                                         (128, 16, 768, 4), (8, 12, 1536, 0),
                                         (4, 12, 1536, 0), (1, 12, 1536, 0),
                                         (128, 6, 1536, 0), (128, 12, 5248, 4),
                                         (128, 12, 5312, 0)])
def test_stream_form_picks(B, H, S_, want):
    assert decode_cross.stream_heads(B, H, S_) == want


@pytest.mark.parametrize("H", [12, 16, 20])
def test_stream_form_crossover(H):
    """The form changes where B * H reaches STREAM_PAIRS_PER_SM per SM, on
    the H100's 132 SMs and on a card of half as many."""
    for sms in (decode_cross.H100_SMS, decode_cross.H100_SMS // 2):
        edge = -(-decode_cross.STREAM_PAIRS_PER_SM * sms // H)
        assert decode_cross.stream_heads(edge, H, 1536, sms) == decode_cross.STREAM_HEADS
        assert decode_cross.stream_heads(edge - 1, H, 1536, sms) == 0


def test_stream_shared_bytes():
    """Eight stages of 64 rows x 4 heads (16 KB of int8 and 1 KB of
    scales), the item's 4 x S_pad scores, 8 warps' 4 x 64 partials."""
    G, W = decode_cross.STREAM_HEADS, decode_cross.STREAM_WARPS
    stage = G * 64 * (64 + 4)
    for S_ in (768, 1536):
        assert decode_cross.stream_shared_bytes(S_) == \
            16 * 8 + 8 * stage + 4 * G * S_ + 4 * W * G * 64 + 4 * W
    assert decode_cross.stream_shared_bytes(1536) == 172_192
    assert decode_cross.stream_shared_bytes(5248) <= decode_cross.MAX_STREAM_SHARED_BYTES
    assert decode_cross.stream_shared_bytes(5312) > decode_cross.MAX_STREAM_SHARED_BYTES


@pytest.mark.parametrize("H", [4, 12, 16, 20])
@pytest.mark.parametrize("sms", [decode_cross.H100_SMS, 7])
def test_stream_items_cover_every_pair_once(H, sms):
    """Around the crossover and far past it, the large-batch form's blocks
    take every (sample, head) exactly once, min(items, SMs) blocks whose
    item counts differ by at most one."""
    G = decode_cross.STREAM_HEADS
    edge = -(-decode_cross.STREAM_PAIRS_PER_SM * sms // H)
    for B in sorted({1, 2, max(1, edge - 1), edge, edge + 1, 2 * edge + 3, 128}):
        blocks = decode_cross.stream_items(B, H, sms)
        items = B * H // G
        assert len(blocks) == min(items, sms)
        pairs = [(b, h) for block in blocks for b, heads in block for h in heads]
        assert sorted(pairs) == [(b, h) for b in range(B) for h in range(H)]
        counts = [len(block) for block in blocks]
        assert min(counts) >= 1 and max(counts) - min(counts) <= 1


@pytest.mark.parametrize("S_,want", [(64, (1, 64)), (128, (1, 128)), (512, (2, 256)),
                                     (1536, (6, 256)), (2048, (8, 256)), (33408, (8, 4176))])
def test_cluster_split_picks(S_, want):
    """C = ceil(S_pad / 256) blocks, at most 8; whisper's 1536 rows go to 6
    blocks of 256."""
    assert decode_cross.cluster_split(S_) == want


def test_cluster_split_covers_every_row_once():
    for S_ in range(64, 40_000, 64):
        C, rows = decode_cross.cluster_split(S_)
        assert 1 <= C <= decode_cross.MAX_CLUSTER
        covered = [s for r in range(C) for s in range(r * rows, min(S_, (r + 1) * rows))]
        assert covered == list(range(S_)), S_
        assert (C - 1) * rows < S_          # no block is left without rows


def test_every_shape_the_single_block_kernels_took_is_taken():
    """The single-block K3 took S_pad up to 8128 ((S_pad + 4096) fp32 in
    48 KB) and K5 4 * K * max(S_pad, 512) bytes in 227 KB; the cluster
    split takes all of them at every K."""
    for S_ in range(64, 8129, 64):
        assert decode_cross.beam_shared_bytes(1, S_) <= decode_cross.MAX_SHARED_BYTES
    for K in decode_cross.KERNEL_BEAM_WIDTHS:
        took = [S_ for S_ in range(64, 70_000, 64) if 4 * K * max(S_, 512) <= 232_448 - 128]
        assert all(decode_cross.beam_shared_bytes(K, S_) <= decode_cross.MAX_SHARED_BYTES
                   for S_ in took)
