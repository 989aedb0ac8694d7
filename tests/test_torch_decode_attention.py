"""K10's plain version (sar_tpu_torch/ops/attic/attention.py) against the
JAX package's parked flash-decode kernel run in Pallas interpret mode and
against its jnp reference, at tests/test_pallas_attention.py's shapes
(B=2, H=4, S=64, hd=64): full and masked, fp32 within 1e-5 (that test's
tolerance) and bf16 within 2e-2 (the normalised probabilities and the
output are rounded to bf16 in both), and the tail exclusion. Also the
valid length as a 0-d tensor, CPU dispatch without a launch, and a tensor
on a device with no kernel raising. Also once at whisper-small's cross
width (B=2, H=12, S=1500) against both, and the kernel's
cluster split: for every S up to 4096 the slices of at most 8 blocks cover
0..S-1 once, and every S the single-block kernel took (S <= 58,080) still
fits a block's shared memory."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import t

from sar_tpu.ops.attic.attention import decode_attention as jax_kernel
from sar_tpu.ops.attic.attention import decode_attention_reference as jax_reference
from sar_tpu_torch.ops.attic import attention

B, H, S, hd = 2, 4, 64, 64
TOLS = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((B, H, hd)).astype(np.float32) * hd ** -0.5,
            rng.standard_normal((B, H, S, hd)).astype(np.float32),
            rng.standard_normal((B, H, S, hd)).astype(np.float32))


def _run(qkv, dtype, valid):
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in qkv]
    jv = None if valid is None else jnp.int32(valid)
    want_k = jax_kernel(*jargs, valid_len=jv, interpret=True)
    want_r = jax_reference(*jargs, valid_len=jv)
    got = attention.decode_attention(*(t(a).to(getattr(torch, dtype)) for a in qkv),
                                     valid_len=valid)
    return got, [np.asarray(w.astype(jnp.float32)) for w in (want_k, want_r)]


@pytest.mark.parametrize("valid", [None, 1, 17, 64], ids=["full", "1", "17", "64"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax(qkv, dtype, valid):
    got, wants = _run(qkv, dtype, valid)
    assert got.shape == (B, H, hd) and got.dtype == getattr(torch, dtype)
    for want in wants:
        np.testing.assert_allclose(got.float().numpy(), want, atol=TOLS[dtype],
                                   rtol=TOLS[dtype])


def test_mask_excludes_tail(qkv):
    q, k, v = (t(a) for a in qkv)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 20:], v2[:, :, 20:] = 999.0, -999.0
    a = attention.decode_attention(q, k, v, valid_len=20)
    b = attention.decode_attention(q, k2, v2, valid_len=torch.tensor(20, dtype=torch.int32))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_cpu_dispatch_and_refusals(qkv):
    args = [t(a).to(torch.bfloat16) for a in qkv]
    n = attention.LAUNCHES
    attention.decode_attention(*args)
    assert attention.LAUNCHES == n
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        attention.decode_attention(*meta)


@pytest.mark.parametrize("valid", [None, 750], ids=["full", "750"])
def test_plain_version_matches_jax_at_the_cross_width(valid):
    rng = np.random.default_rng(1)
    Bc, Hc, Sc = 2, 12, 1500
    qkv = (rng.standard_normal((Bc, Hc, hd)).astype(np.float32) * hd ** -0.5,
           rng.standard_normal((Bc, Hc, Sc, hd)).astype(np.float32),
           rng.standard_normal((Bc, Hc, Sc, hd)).astype(np.float32))
    jv = None if valid is None else jnp.int32(valid)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in qkv]
    wants = (jax_kernel(*jargs, valid_len=jv, interpret=True), jax_reference(*jargs, valid_len=jv))
    got = attention.decode_attention(*(t(a).to(torch.bfloat16) for a in qkv), valid_len=valid)
    assert got.shape == (Bc, Hc, hd)
    for want in wants:
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=TOLS["bfloat16"], rtol=TOLS["bfloat16"])


def test_cluster_split_covers_every_row_once():
    for S_ in range(1, 4097):
        C, rows = attention.cluster_split(S_)
        assert 1 <= C <= attention.MAX_CLUSTER
        covered = [s for r in range(C) for s in range(r * rows, min(S_, (r + 1) * rows))]
        assert covered == list(range(S_)), S_
        assert (C - 1) * rows < S_          # no block is left without rows


def test_every_length_the_single_block_kernel_took_is_taken():
    old_limit = 232_448 - 128                # the single-block kernel: 4 * max(S, 512) bytes
    took = [S_ for S_ in range(1, 70_000) if 4 * max(S_, 512) <= old_limit]
    assert took[-1] == 58_080
    assert all(attention.shared_bytes(S_) <= attention.MAX_SHARED_BYTES for S_ in took)
    # A slice longer than the ring streams through it: the bytes stop growing
    # with the ring's 8 stages of 32 rows.
    assert attention.shared_bytes(58_080) == 8 * 32 * 64 * 2 + 7260 * 4
