"""K1-K10 hand-written CUDA kernels against their plain PyTorch versions on
the card, in bf16, at small shapes (marked `cuda`: they need an NVIDIA GPU
with nvcc and skip elsewhere; chip_smoke.py runs the same comparisons at
whisper-small shapes). Run on the card with
`python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q`."""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(g, dev, *shape, std=1.0):
    return (torch.randn(shape, generator=g, device=dev) * std).to(torch.bfloat16)


# Shapes: a small one, whisper-small's and whisper-large-v3's widths (the
# kernel needs no column groups at d_model 1280), and a T_pad that is no
# multiple of the 128-row query tile or the 64-key tile.
@pytest.mark.parametrize("B,T,H,t_valid", [(2, 128, 2, 100), (1, 1536, 12, 1500),
                                           (1, 1536, 20, 1500), (2, 100, 3, 77)])
def test_encoder_attention_kernel(dev, B, T, H, t_valid):
    from sar_tpu_torch.ops import flash_enc
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_randn(g, dev, B, T, H * 64, std=s) for s in (0.125, 1.0, 1.0))
    n = flash_enc.LAUNCHES
    got = flash_enc.encoder_attention_hm(q, k, v, n_heads=H, t_valid=t_valid)
    want = flash_enc.encoder_attention_hm_reference(q, k, v, n_heads=H, t_valid=t_valid)
    torch.cuda.synchronize()
    assert flash_enc.LAUNCHES == n + 1
    err = (got[:, :t_valid].float() - want[:, :t_valid].float()).abs().max().item()
    assert err <= 2e-2


def _rounding_case(dev):
    """_torch_port.bf16_rounding_case on the card: q/k/v [1, 16, 64] bf16 whose
    two valid keys give probabilities 1 and exp(-2^-10), equal once rounded
    to bf16, with values +1 and -1 (garbage past them)."""
    from _torch_port import bf16_rounding_case
    return [torch.from_numpy(x).to(dev, torch.bfloat16) for x in bf16_rounding_case(16)]


def test_encoder_attention_kernel_rounds_probabilities_to_bf16(dev):
    """K1 rounds the unnormalised probabilities to bf16 before the PV
    product, as the TPU kernel does: the valid rows are 0 (a kernel that
    keeps them in fp32 gives 4.88e-4)."""
    from sar_tpu_torch.ops import flash_enc
    q, k, v = _rounding_case(dev)
    n = flash_enc.LAUNCHES
    got = flash_enc.encoder_attention_hm(q, k, v, n_heads=1, t_valid=2)
    torch.cuda.synchronize()
    assert flash_enc.LAUNCHES == n + 1
    assert got[:, :2].float().abs().max().item() <= 1e-6


def test_flash_attention_fwd_kernel_rounds_probabilities_to_bf16(dev):
    """K6's forward on the same case ([1, 1, 2, 64] head-major views of the
    two valid rows): 0."""
    from sar_tpu_torch.ops import flash
    q, k, v = (x[:, :2, None].transpose(1, 2) for x in _rounding_case(dev))
    n = flash.LAUNCHES
    o, lse = flash.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert flash.LAUNCHES == n + 1
    assert o.float().abs().max().item() <= 1e-6 and torch.isfinite(lse).all()


@pytest.mark.parametrize("H", [2, 12, 20])
def test_kv_init_kernel(dev, H):
    from sar_tpu_torch.ops import kv_init
    g = torch.Generator(device=dev).manual_seed(1)
    L, B, S, S_pad = 2, 2, 100, 128
    D = H * 64
    x = _randn(g, dev, B, S_pad, D)
    x[:, S:] = 0
    wk, wv, bv = _randn(g, dev, L, D, D, std=0.05), _randn(g, dev, L, D, D, std=0.05), \
        _randn(g, dev, L, D, std=0.05)
    got = kv_init.fused_kv_init(x, wk, wv, bv, n_heads=H, t_valid=S)
    want = kv_init.fused_kv_init_reference(x, wk, wv, bv, n_heads=H, t_valid=S)
    torch.cuda.synchronize()
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        d = (a.int() - b.int()).abs()
        assert d.max().item() <= 1 and (d != 0).float().mean().item() <= 5e-3
        assert not a[:, :, S:].any()
    for a, b in ((got[1], want[1]), (got[3], want[3])):
        assert not a[..., S:].any()
        assert ((a[..., :S] - b[..., :S]).abs() / b[..., :S]).max().item() <= 1e-2


def _assert_kv_rules(got, want, S):
    """K2's rules: int8 |d| <= 1 on <= 5e-3 of entries, scales within rel
    1e-2, pad rows 0 with scale 0."""
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        d = (a.int() - b.int()).abs()
        assert d.max().item() <= 1 and (d != 0).float().mean().item() <= 5e-3
        assert not a[:, :, S:].any()
    for a, b in ((got[1], want[1]), (got[3], want[3])):
        assert not a[..., S:].any()
        assert ((a[..., :S] - b[..., :S]).abs() / b[..., :S]).max().item() <= 1e-2


# K4: the smallest legal shape and whisper-large-v3's width, ranks 8 (padded
# to the kernel's 16), 16 and 64, per-sample and shared (broadcast) slices.
@pytest.mark.parametrize("H", [2, 20])
@pytest.mark.parametrize("r", [8, 16, 64])
@pytest.mark.parametrize("shared", [False, True])
def test_kv_init_lora_kernel(dev, H, r, shared):
    from sar_tpu_torch.ops import kv_init
    g = torch.Generator(device=dev).manual_seed(3)
    L, B, S, S_pad = 2, 3, 100, 128
    D = H * 64
    x = _randn(g, dev, B, S_pad, D)
    x[:, S:] = 0
    wk, wv, bv = _randn(g, dev, L, D, D, std=0.05), _randn(g, dev, L, D, D, std=0.05), \
        _randn(g, dev, L, D, std=0.05)
    Bv = 1 if shared else B
    va, vb = _randn(g, dev, L, Bv, D, r, std=0.1), _randn(g, dev, L, Bv, r, D, std=0.1)
    n2, n4 = kv_init.LAUNCHES, kv_init.LORA_LAUNCHES
    got = kv_init.fused_kv_init(x, wk, wv, bv, n_heads=H, t_valid=S, va=va, vb=vb,
                                lora_scale=2.0)
    want = kv_init.fused_kv_init_reference(x, wk, wv, bv, n_heads=H, t_valid=S,
                                           va=va, vb=vb, lora_scale=2.0)
    torch.cuda.synchronize()
    assert (kv_init.LAUNCHES, kv_init.LORA_LAUNCHES) == (n2, n4 + 1)
    _assert_kv_rules(got, want, S)
    # The LoRA term moved V: the unadapted kernel's V differs.
    plain = kv_init.fused_kv_init(x, wk, wv, bv, n_heads=H, t_valid=S)
    assert (plain[2] != got[2]).any()


def test_kv_init_lora_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from sar_tpu_torch.ops import kv_init
    L, B, S_pad, D = 1, 2, 64, 128
    x = torch.zeros((B, S_pad, D), dtype=torch.bfloat16, device=dev)
    w = torch.zeros((L, D, D), dtype=torch.bfloat16, device=dev)
    bv = torch.zeros((L, D), dtype=torch.bfloat16, device=dev)
    for r, Bv in ((65, 1), (16, 3)):
        va = torch.zeros((L, Bv, D, r), dtype=torch.bfloat16, device=dev)
        vb = torch.zeros((L, Bv, r, D), dtype=torch.bfloat16, device=dev)
        with pytest.raises(ValueError):
            kv_init.fused_kv_init(x, w, w, bv, n_heads=2, t_valid=50, va=va, vb=vb)


def _k3_counts():
    from sar_tpu_torch.ops import decode_cross
    return decode_cross.LAUNCHES, decode_cross.STREAM_LAUNCHES, decode_cross.BEAM_LAUNCHES


def _k3_form(dev, B, H, S_pad):
    """The form K3 takes here (the heads of a large-batch item, or 0 for
    the cluster form), the Python mirror held to the library's."""
    from sar_tpu_torch.ops import _build, decode_cross
    G = decode_cross.stream_heads(B, H, S_pad, _build.sm_count(dev))
    assert decode_cross.launched_form(B, H, S_pad, dev) == G
    return G


# K3 on both sides of the crossover to its large-batch form: B=3 (the
# cluster form) and B=80 (the large-batch form at 4 and 20 heads on an
# H100), then the accepted cells' shapes (small.eval.long, turbo.eval.short,
# owsm.eval.short), every layer of the cache; where H divides into the
# large-batch items, both forms through the probe entry as well.
@pytest.mark.parametrize("B,H,S,S_pad", [(3, 4, 100, 128), (3, 20, 100, 128), (80, 4, 100, 128),
                                         (80, 20, 100, 128), (128, 12, 1500, 1536),
                                         (64, 20, 1500, 1536), (128, 16, 749, 768)])
def test_cross_decode_kernel(dev, B, H, S, S_pad):
    from sar_tpu_torch.ops import decode_cross, kv_init
    g = torch.Generator(device=dev).manual_seed(2)
    L = 2
    D = H * 64
    x = _randn(g, dev, B, S_pad, D)
    x[:, S:] = 0
    w = _randn(g, dev, L, D, D, std=0.05)
    kq, ks, vq, vs = kv_init.fused_kv_init_reference(
        x, w, w, torch.zeros((L, D), dtype=torch.bfloat16, device=dev), n_heads=H, t_valid=S)
    q = _randn(g, dev, B, D, std=0.125)
    G = _k3_form(dev, B, H, S_pad)
    assert (G > 0) == (B >= 64)
    for layer in range(L):
        n = _k3_counts()
        got = decode_cross.cross_decode_attention_exact(q, kq, ks, vq, vs, layer=layer, n_heads=H)
        want = decode_cross.cross_decode_reference_exact(q, kq, ks, vq, vs, layer=layer, n_heads=H)
        torch.cuda.synchronize()
        assert _k3_counts() == (n[0] + 1, n[1] + (G > 0), n[2])
        assert (got.float() - want.float()).abs().max().item() <= 2e-2
        for form in (0, 1) if H % decode_cross.STREAM_HEADS == 0 else ():
            one = decode_cross.cross_decode_exact_form(q, kq, ks, vq, vs, layer=layer,
                                                       n_heads=H, form=form)
            torch.cuda.synchronize()
            assert _k3_counts() == (n[0] + 1, n[1] + (G > 0), n[2])
            assert (one.float() - want.float()).abs().max().item() <= 2e-2
            if form == (G > 0):
                assert torch.equal(one, got)


def _beam_cache(g, dev, L, B, S, S_pad, H):
    """A kernel-layout int8 cache with pad rows (scale 0) past S."""
    from sar_tpu_torch.ops import kv_init
    D = H * 64
    x = _randn(g, dev, B, S_pad, D)
    x[:, S:] = 0
    w = _randn(g, dev, L, D, D, std=0.05)
    return kv_init.fused_kv_init_reference(
        x, w, w, torch.zeros((L, D), dtype=torch.bfloat16, device=dev), n_heads=H, t_valid=S)


# K5: beam widths 2, 4 (the smoke run's), 5 (Whisper's usual) and 8 (the
# largest instance, 48 KB of scores: above the default shared-memory limit),
# at d_model 128 and whisper-small's 768, S_pad 1536 with 36 pad rows, every
# layer of a 3-layer cache (offsets > 0).
@pytest.mark.parametrize("H", [2, 12])
@pytest.mark.parametrize("K", [2, 4, 5, 8])
def test_cross_decode_beam_kernel(dev, H, K):
    from sar_tpu_torch.ops import decode_cross
    g = torch.Generator(device=dev).manual_seed(4)
    L, B, S, S_pad = 3, 2, 1500, 1536
    kq, ks, vq, vs = _beam_cache(g, dev, L, B, S, S_pad, H)
    q = _randn(g, dev, B, K, H * 64, std=0.125)
    for layer in range(L):
        n3, n5 = decode_cross.LAUNCHES, decode_cross.BEAM_LAUNCHES
        got = decode_cross.cross_decode_attention_exact(q, kq, ks, vq, vs, layer=layer, n_heads=H)
        want = decode_cross.cross_decode_reference_exact(q, kq, ks, vq, vs, layer=layer, n_heads=H)
        torch.cuda.synchronize()
        assert (decode_cross.LAUNCHES, decode_cross.BEAM_LAUNCHES) == (n3, n5 + 1)
        assert got.shape == (B, K, H * 64) and torch.isfinite(got.float()).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 and err <= 2e-2 * want.float().abs().max().item()


def test_cross_decode_beam_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from sar_tpu_torch.ops import decode_cross
    L, B, S_pad, H = 1, 2, 128, 2
    kq = torch.zeros((L, B, S_pad, H * 64), dtype=torch.int8, device=dev)
    ks = torch.ones((L, B, H, S_pad), device=dev)
    for K in (1, 9):
        q = torch.zeros((B, K, H * 64), dtype=torch.bfloat16, device=dev)
        with pytest.raises(ValueError, match="beam widths"):
            decode_cross.cross_decode_attention_exact(q, kq, ks, kq, ks, layer=0, n_heads=H)
    # The cluster split's slice of 4184 rows at K=8 needs more than a
    # block's shared memory (S_pad 33,408 is the largest taken).
    big = torch.zeros((L, B, 33472, H * 64), dtype=torch.int8, device=dev)
    bigs = torch.ones((L, B, H, 33472), device=dev)
    q = torch.zeros((B, 8, H * 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="shared"):
        decode_cross.cross_decode_attention_exact(q, big, bigs, big, bigs, layer=0, n_heads=H)


# K3/K5's cluster split at its edges: one block (S_pad 128, C = 1), six
# (whisper's S_pad 1536, slices of 256 rows) with t_valid on a slice
# boundary (1280, also a border of the large-batch form's 64-row ring
# tiles), one past it, and small enough that five slices (and every tile
# past the second) hold padding only, and eight (S_pad 2048) with t_valid
# on a slice boundary; K = 1 (K3) and 2, 4, 8 (K5); B = 2 and B = 80 (K3
# in its large-batch form at these 4 heads, K5 still in clusters); every
# layer of a 3-layer cache; two runs give the same bits (no atomics).
@pytest.mark.parametrize("S_pad,t_valid,C", [(128, 100, 1), (1536, 1280, 6), (1536, 1281, 6),
                                             (1536, 100, 6), (2048, 1536, 8)])
@pytest.mark.parametrize("K", [1, 2, 4, 8])
@pytest.mark.parametrize("B", [2, 80])
def test_cross_decode_cluster_split_edges(dev, S_pad, t_valid, C, K, B):
    from sar_tpu_torch.ops import decode_cross
    g = torch.Generator(device=dev).manual_seed(6)
    L, H = 3, 4
    assert decode_cross.cluster_split(S_pad)[0] == C
    stream = K == 1 and _k3_form(dev, B, H, S_pad) > 0
    assert stream == (K == 1 and B == 80)
    kq, ks, vq, vs = _beam_cache(g, dev, L, B, t_valid, S_pad, H)
    q = _randn(g, dev, B, K, H * 64, std=0.125)
    q = q[:, 0].contiguous() if K == 1 else q
    for layer in range(L):
        n = _k3_counts()
        got = decode_cross.cross_decode_attention_exact(q, kq, ks, vq, vs, layer=layer, n_heads=H)
        again = decode_cross.cross_decode_attention_exact(q, kq, ks, vq, vs, layer=layer, n_heads=H)
        want = decode_cross.cross_decode_reference_exact(q, kq, ks, vq, vs, layer=layer, n_heads=H)
        torch.cuda.synchronize()
        assert _k3_counts() == (n[0] + 2 * (K == 1), n[1] + 2 * stream, n[2] + 2 * (K > 1))
        assert got.shape == q.shape and torch.isfinite(got.float()).all()
        assert torch.equal(got, again)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 and err <= 2e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("B,H", [(2, 2), (80, 4)])
def test_cross_decode_all_rows_masked_is_uniform(dev, K, B, H):
    """A sample whose every key scale is 0 attends uniformly over all S_pad
    rows, as the TPU kernel's softmax of all -1e30 does: in the cluster
    form (B=2) and, for K3, in the large-batch form (B=80 at 4 heads)."""
    from sar_tpu_torch.ops import decode_cross
    g = torch.Generator(device=dev).manual_seed(7)
    L, S_pad = 2, 1536
    assert (K == 1 and _k3_form(dev, B, H, S_pad) > 0) == (K == 1 and B == 80)
    kq, ks, vq, vs = _beam_cache(g, dev, L, B, 1500, S_pad, H)
    ks = ks.clone()
    ks[:, 1] = 0
    q = _randn(g, dev, B, K, H * 64, std=0.125)
    q = q[:, 0].contiguous() if K == 1 else q
    got = decode_cross.cross_decode_attention_exact(q, kq, ks, vq, vs, layer=1, n_heads=H)
    want = decode_cross.cross_decode_reference_exact(q, kq, ks, vq, vs, layer=1, n_heads=H)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


# K2 at every Whisper width (tiny 384 .. large 1280), t_valid at the
# 128-row tile's edge and one past it, and an S_pad of 192 (no multiple of
# 128: the 64-row configuration).
@pytest.mark.parametrize("H", [6, 8, 12, 16, 20])
@pytest.mark.parametrize("S_pad,t_valid", [(256, 128), (256, 129), (192, 150)])
def test_kv_init_kernel_widths_and_tile_edges(dev, H, S_pad, t_valid):
    from sar_tpu_torch.ops import kv_init
    g = torch.Generator(device=dev).manual_seed(8)
    L, B = 2, 2
    D = H * 64
    assert kv_init.kv_config(S_pad, H)[0] == (128 if S_pad % 128 == 0 else 64)
    x = _randn(g, dev, B, S_pad, D)
    x[:, t_valid:] = 0
    wk, wv, bv = _randn(g, dev, L, D, D, std=0.05), _randn(g, dev, L, D, D, std=0.05), \
        _randn(g, dev, L, D, std=0.05)
    n = kv_init.LAUNCHES
    got = kv_init.fused_kv_init(x, wk, wv, bv, n_heads=H, t_valid=t_valid)
    want = kv_init.fused_kv_init_reference(x, wk, wv, bv, n_heads=H, t_valid=t_valid)
    torch.cuda.synchronize()
    assert kv_init.LAUNCHES == n + 1
    _assert_kv_rules(got, want, t_valid)


# K4 at every Whisper width, per-sample and broadcast slices, r = 16, with
# t_valid one past the row tile's edge.
@pytest.mark.parametrize("H", [6, 8, 12, 16, 20])
@pytest.mark.parametrize("shared", [False, True])
def test_kv_init_lora_kernel_widths(dev, H, shared):
    from sar_tpu_torch.ops import kv_init
    g = torch.Generator(device=dev).manual_seed(9)
    L, B, S_pad, t_valid, r = 2, 2, 256, 129, 16
    D = H * 64
    x = _randn(g, dev, B, S_pad, D)
    x[:, t_valid:] = 0
    wk, wv, bv = _randn(g, dev, L, D, D, std=0.05), _randn(g, dev, L, D, D, std=0.05), \
        _randn(g, dev, L, D, std=0.05)
    Bv = 1 if shared else B
    va, vb = _randn(g, dev, L, Bv, D, r, std=0.1), _randn(g, dev, L, Bv, r, D, std=0.1)
    n4 = kv_init.LORA_LAUNCHES
    got = kv_init.fused_kv_init(x, wk, wv, bv, n_heads=H, t_valid=t_valid, va=va, vb=vb,
                                lora_scale=2.0)
    want = kv_init.fused_kv_init_reference(x, wk, wv, bv, n_heads=H, t_valid=t_valid,
                                           va=va, vb=vb, lora_scale=2.0)
    torch.cuda.synchronize()
    assert kv_init.LORA_LAUNCHES == n4 + 1
    _assert_kv_rules(got, want, t_valid)


def _s8_query(g, dev, B, K, H, folded):
    """A pre-scaled bf16 query quantized per (row, head) as decode_step
    does: qq [B, D] (or [B, K, D]) s8 and qs [B, K*H, 1] fp32."""
    from sar_tpu_torch.models import whisper
    q = _randn(g, dev, B, K, H * 64, std=0.125)
    qq, qs = whisper.quantize_kv(q.reshape(B, K, H, 64))
    qq = qq.reshape(B, K, H * 64) if folded else qq.reshape(B, H * 64)
    return qq, qs.reshape(B, K * H, 1)


# K7: greedy (K=1, q [B, D]) and beam widths 2, 4 and 8 (the largest
# instance: 60 KB of scores and s8 probabilities, above the default
# shared-memory limit), at d_model 128, whisper-small's 768 and
# whisper-large-v3's 1280, S_pad 1536 with 36 pad rows, every layer of a
# 3-layer cache. Limit: 2e-2 absolute and relative to the largest entry
# (the bf16 output, and a re-quantized probability that a softmax summed
# in another order can move across a .5 boundary).
@pytest.mark.parametrize("H", [2, 12, 20])
@pytest.mark.parametrize("K", [1, 2, 4, 8])
def test_cross_decode_s8_kernel(dev, H, K):
    from sar_tpu_torch.ops import decode_cross
    g = torch.Generator(device=dev).manual_seed(5)
    L, B, S, S_pad = 3, 2, 1500, 1536
    kq, ks, vq, vs = _beam_cache(g, dev, L, B, S, S_pad, H)
    qq, qs = _s8_query(g, dev, B, K, H, folded=K > 1)
    for layer in range(L):
        n = (decode_cross.S8_LAUNCHES, decode_cross.S8_BEAM_LAUNCHES)
        got = decode_cross.cross_decode_attention(qq, qs, kq, ks, vq, vs, layer=layer,
                                                  n_heads=H)
        want = decode_cross.cross_decode_reference(qq, qs, kq, ks, vq, vs, layer=layer,
                                                   n_heads=H)
        torch.cuda.synchronize()
        assert (decode_cross.S8_LAUNCHES, decode_cross.S8_BEAM_LAUNCHES) == \
            (n[0] + (K == 1), n[1] + (K > 1))
        assert got.shape == qq.shape and got.dtype == torch.bfloat16
        assert torch.isfinite(got.float()).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 and err <= 2e-2 * want.float().abs().max().item()


def test_cross_decode_s8_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from sar_tpu_torch.ops import decode_cross
    g = torch.Generator(device=dev).manual_seed(6)
    L, B, S_pad, H = 1, 2, 128, 2
    kq = torch.zeros((L, B, S_pad, H * 64), dtype=torch.int8, device=dev)
    ks = torch.ones((L, B, H, S_pad), device=dev)
    qq, qs = _s8_query(g, dev, B, 9, H, folded=True)
    with pytest.raises(ValueError, match="beam widths"):
        decode_cross.cross_decode_attention(qq, qs, kq, ks, kq, ks, layer=0, n_heads=H)
    qq, qs = _s8_query(g, dev, B, 1, H, folded=False)
    with pytest.raises(ValueError, match="bfloat16"):
        decode_cross.cross_decode_attention(qq, qs, kq, ks, kq, ks, layer=0, n_heads=H,
                                            out_dtype=torch.float32)
    with pytest.raises(ValueError, match="qs"):
        decode_cross.cross_decode_attention(qq, qs[:, :1].contiguous(), kq, ks, kq, ks, layer=0,
                                            n_heads=H)
    with pytest.raises(ValueError, match="int8"):
        decode_cross.cross_decode_attention(qq.float(), qs, kq, ks, kq, ks, layer=0, n_heads=H)
    with pytest.raises(ValueError, match="layer"):
        decode_cross.cross_decode_attention(qq, qs, kq, ks, kq, ks, layer=1, n_heads=H)
    # The cluster split's slice of 3048 rows at K=8 needs more than a
    # block's shared memory (S_pad 24,320 is the largest taken).
    big = torch.zeros((L, B, 24384, H * 64), dtype=torch.int8, device=dev)
    bigs = torch.ones((L, B, H, 24384), device=dev)
    qq, qs = _s8_query(g, dev, B, 8, H, folded=True)
    with pytest.raises(ValueError, match="shared"):
        decode_cross.cross_decode_attention(qq, qs, big, bigs, big, bigs, layer=0, n_heads=H)


# K7's cluster split at its edges: one block (S_pad 128, a plain launch),
# three (whisper's S_pad 1536, slices of 512 rows) with t_valid on a slice
# boundary (1024), one past it, and small enough that two slices hold
# padding only, four (S_pad 2048, t_valid on a boundary), and eight (8192:
# slices of 1024 rows stream through the 512-row v ring); K = 1, 2, 4 and
# 8; every layer of a 3-layer cache; two runs give the same bits (no
# atomics). Limit as test_cross_decode_s8_kernel's.
@pytest.mark.parametrize("S_pad,t_valid,C", [(128, 100, 1), (1536, 1024, 3), (1536, 1025, 3),
                                             (1536, 100, 3), (2048, 1536, 4), (8192, 8000, 8)])
@pytest.mark.parametrize("K", [1, 2, 4, 8])
def test_cross_decode_s8_cluster_split_edges(dev, S_pad, t_valid, C, K):
    from sar_tpu_torch.ops import decode_cross
    g = torch.Generator(device=dev).manual_seed(12)
    L, B, H = 3, 2, 4
    assert decode_cross.s8_cluster_split(S_pad)[0] == C
    kq, ks, vq, vs = _beam_cache(g, dev, L, B, t_valid, S_pad, H)
    qq, qs = _s8_query(g, dev, B, K, H, folded=K > 1)
    for layer in range(L):
        got = decode_cross.cross_decode_attention(qq, qs, kq, ks, vq, vs, layer=layer, n_heads=H)
        again = decode_cross.cross_decode_attention(qq, qs, kq, ks, vq, vs, layer=layer,
                                                    n_heads=H)
        want = decode_cross.cross_decode_reference(qq, qs, kq, ks, vq, vs, layer=layer,
                                                   n_heads=H)
        torch.cuda.synchronize()
        assert got.shape == qq.shape and torch.isfinite(got.float()).all()
        assert torch.equal(got, again)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 and err <= 2e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("K", [1, 4])
def test_cross_decode_s8_all_rows_masked_is_uniform(dev, K):
    """A sample whose every key scale is 0 (every slice all padding) attends
    uniformly over all S_pad rows, as the TPU kernel's softmax of all -1e30
    does; its v scales are 0 there too, so its output is 0."""
    from sar_tpu_torch.ops import decode_cross
    g = torch.Generator(device=dev).manual_seed(13)
    L, B, S_pad, H = 2, 2, 1536, 2
    kq, ks, vq, vs = _beam_cache(g, dev, L, B, 1500, S_pad, H)
    ks, vs = ks.clone(), vs.clone()
    ks[:, 1] = 0
    vs[:, 1, :, 1500:] = 1.0 / 127   # pad rows with a v scale: the uniform average shows
    qq, qs = _s8_query(g, dev, B, K, H, folded=K > 1)
    got = decode_cross.cross_decode_attention(qq, qs, kq, ks, vq, vs, layer=1, n_heads=H)
    want = decode_cross.cross_decode_reference(qq, qs, kq, ks, vq, vs, layer=1, n_heads=H)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and want[1].float().abs().max().item() > 0
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 and err <= 2e-2 * want.float().abs().max().item()


def test_beam_decode_kernels_agree_with_the_plain_path(dev):
    """A short bf16 beam decode at d_model 128 (2 heads of 64): the kernel
    path (K2 + K5) and the plain path pick the same tokens on most
    positions (bf16 sums in another order can flip a near tie)."""
    from sar_tpu_torch.decode import beam_decode
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.models.config import get_config
    from sar_tpu_torch.ops import decode_cross
    cfg = dataclasses.replace(get_config("whisper-test"), d_model=128, encoder_heads=2,
                              decoder_heads=2, ffn_dim=256)
    params = whisper.cast_params(
        whisper.init_params(cfg, torch.Generator(device=dev).manual_seed(6), dev), torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(7)
    enc = torch.randn((3, cfg.max_source_positions, cfg.d_model), generator=g,
                      device=dev).to(torch.bfloat16)
    prompt = cfg.prompt_ids("english")
    n5 = decode_cross.BEAM_LAUNCHES
    int8 = dict(cross_kv_int8=True, self_kv_int8=True)
    got = beam_decode(params, enc, cfg, prompt, num_beams=4, max_new_tokens=12, **int8)
    assert decode_cross.BEAM_LAUNCHES > n5
    want = beam_decode(params, enc, cfg, prompt, num_beams=4, max_new_tokens=12, kernels=False,
                       **int8)
    assert got.shape == want.shape and torch.equal(got[:, :len(prompt)], want[:, :len(prompt)])
    assert (got == want).float().mean().item() >= 0.9


@pytest.mark.parametrize("num_beams", [1, 4])
def test_s8_decode_kernels_agree_with_the_plain_path(dev, num_beams):
    """A short bf16 `scores_int8` decode at d_model 128 (2 heads of 64),
    greedy and 4 beams (the physical-reorder path): K7 runs once per layer
    of every step, K3/K5 not at all, and the kernel path (K2 + K7) and the
    plain path pick the same tokens on most positions (a softmax summed in
    another order can move a re-quantized probability, and flip a near
    tie). The int4 cache runs on the card too (plain torch, no decode
    kernel)."""
    from sar_tpu_torch.decode import beam_decode, greedy_decode
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.models.config import get_config
    from sar_tpu_torch.ops import decode_cross
    cfg = dataclasses.replace(get_config("whisper-test"), d_model=128, encoder_heads=2,
                              decoder_heads=2, ffn_dim=256)
    params = whisper.cast_params(
        whisper.init_params(cfg, torch.Generator(device=dev).manual_seed(6), dev), torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(8)
    enc = torch.randn((3, cfg.max_source_positions, cfg.d_model), generator=g,
                      device=dev).to(torch.bfloat16)
    prompt = cfg.prompt_ids("english")

    def run(**kw):
        if num_beams == 1:
            return greedy_decode(params, enc, cfg, prompt, max_new_tokens=12, **kw)
        return beam_decode(params, enc, cfg, prompt, num_beams=num_beams, max_new_tokens=12, **kw)

    def counts():
        return (decode_cross.S8_LAUNCHES, decode_cross.S8_BEAM_LAUNCHES,
                decode_cross.LAUNCHES, decode_cross.BEAM_LAUNCHES)
    n = counts()
    s8_kw = dict(cross_kv_int8=True, self_kv_int8=True, scores_int8=True)
    got = run(**s8_kw)
    torch.cuda.synchronize()
    s8, s8_beam, k3, k5 = (c - c0 for c, c0 in zip(counts(), n))
    launched = s8 if num_beams == 1 else s8_beam
    assert launched > 0 and launched % cfg.decoder_layers == 0
    assert (k3, k5) == (0, 0) and (s8_beam if num_beams == 1 else s8) == 0
    want = run(kernels=False, **s8_kw)
    assert got.shape == want.shape and torch.equal(got[:, :len(prompt)], want[:, :len(prompt)])
    assert (got == want).float().mean().item() >= 0.9
    n = counts()
    int4 = run(cross_kv_int4=True, self_kv_int4=True)
    assert counts() == n and int4.shape == got.shape
    assert torch.equal(int4, run(cross_kv_int4=True, self_kv_int4=True, kernels=False))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from sar_tpu_torch.ops import flash_enc
    q = torch.zeros((1, 128, 128), device=dev)           # fp32: kernel takes bf16
    with pytest.raises(ValueError, match="bfloat16"):
        flash_enc.encoder_attention_hm(q, q, q, n_heads=2, t_valid=100)
    q = torch.zeros((1, 100, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="hold t_valid"):
        flash_enc.encoder_attention_hm(q, q, q, n_heads=2, t_valid=101)
    with pytest.raises(ValueError, match="head_dim"):
        flash_enc.encoder_attention_hm(q, q, q, n_heads=4, t_valid=100)


def _k6_inputs(dev, B, H, Tq, Tk, seed=8):
    """q/k/v as the model makes them: [B, T, H*64] projections viewed as
    [B, H, T, 64] (q pre-scaled), and an upstream gradient in o's layout."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def heads(T, std):
        return _randn(g, dev, B, T, H * 64, std=std).view(B, T, H, 64).transpose(1, 2)
    q, k, v = heads(Tq, 0.125), heads(Tk, 1.0), heads(Tk, 1.0)
    return q, k, v, heads(Tq, 1.0)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max().item()
            / max(want.float().abs().max().item(), 1e-30))


def _k6_errors(q, k, v, do, causal):
    """The kernel path's output and gradients against the plain version's
    (autograd of flash_mha_reference) on the same bf16 inputs, and both
    against the fp32 truth (the plain version on the same values in fp32):
    {name: (kernel vs plain, kernel vs truth, plain vs truth)}, each
    max|a - b| / max|b|."""
    from sar_tpu_torch.ops import flash

    def run(fn, dtype):
        xs = [t.detach().to(dtype).requires_grad_(True) for t in (q, k, v)]
        o = fn(*xs, causal=causal)
        return (o, *torch.autograd.grad(o, xs, do.to(dtype)))

    n = (flash.LAUNCHES, flash.DKV_LAUNCHES, flash.DQ_LAUNCHES)
    got = run(flash.flash_mha, torch.bfloat16)
    torch.cuda.synchronize()
    assert (flash.LAUNCHES, flash.DKV_LAUNCHES, flash.DQ_LAUNCHES) == tuple(c + 1 for c in n)
    want = run(flash.flash_mha_reference, torch.bfloat16)
    truth = run(flash.flash_mha_reference, torch.float32)
    out = {}
    for name, a, b, t in zip(("o", "dq", "dk", "dv"), got, want, truth):
        assert a.shape == b.shape and a.dtype == torch.bfloat16
        assert torch.isfinite(a.float()).all()
        out[name] = (_rel(a, b), _rel(a, t), _rel(b, t))
    return out


# K6 at the smallest tile, causal with a ragged tile, rectangular, a ragged
# cross shape against whisper's 1500 keys, decoder self-attention at T=448
# with B*H = 144 blocks per tile column (> 132 SMs), and the encoder's 1500.
# Limits: the kernel within 2e-2 of the plain version (relative to its
# largest entry), and no further from the fp32 truth than twice the plain
# version's own distance (or 1e-2): both round p, ds and the outputs to
# bf16, at other points and in another summation order.
@pytest.mark.parametrize("B,H,Tq,Tk,causal", [
    (2, 2, 128, 128, False), (1, 2, 100, 100, True), (2, 3, 100, 300, False),
    (3, 4, 77, 1500, False), (2, 1, 1, 70, False), (12, 12, 448, 448, True),
    (2, 12, 1500, 1500, False)])
def test_flash_attention_kernels(dev, B, H, Tq, Tk, causal):
    q, k, v, do = _k6_inputs(dev, B, H, Tq, Tk)
    errs = _k6_errors(q, k, v, do, causal)
    print(f"K6 B={B} H={H} Tq={Tq} Tk={Tk} causal={causal}: " + ", ".join(
        f"{n} {a:.2e} (truth {t:.2e}, plain {p:.2e})" for n, (a, t, p) in errs.items()))
    for name, (vs_plain, vs_truth, plain_vs_truth) in errs.items():
        assert vs_plain <= 2e-2, name
        assert vs_truth <= max(2 * plain_vs_truth, 1e-2), name


def test_flash_attention_lse(dev):
    from sar_tpu_torch.ops import flash
    q, k, v, _ = _k6_inputs(dev, 2, 3, 200, 200)
    for causal in (False, True):
        o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = flash.flash_attention_fwd_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert (lse - lse_ref).abs().max().item() <= 1e-3
        assert _rel(o, o_ref) <= 2e-2


def _bf16_ulp(x):
    """One bf16 ulp at each entry of x >= 0: 2^(floor(log2 x) - 7)."""
    return torch.exp2(torch.floor(torch.log2(x.clamp_min(2.0 ** -126))) - 7)


# The dQ and dK/dV kernels against their own plain versions, given the same
# lse and di. The tensor cores sum each product in k-slices of 16 in their
# own order, and their scores differ from cuBLAS's in the last fp32 bits, so
# a bf16 rounding of p, of ds or of the gradient itself can land on the
# other side of a tie. Limits (the same as chip_smoke.py's):
# - per entry, |kernel - plain| <= one bf16 ulp of max(|kernel|, |plain|)
#   plus BWD_FLOOR of the largest |plain| entry: a flipped bf16(p) or
#   bf16(ds) moves one term of an entry's sum by an ulp of that term, which
#   an entry near 0 cannot absorb in its own ulp (chip_smoke.py reads up
#   to 6.7e-4 of the largest entry at whisper-small's three shapes);
# - the relative Frobenius error <= BWD_FRO_TOL (read 1.3e-4 at most),
#   which a dropped tile, a missed mask or a wrong di exceeds many times.
BWD_FLOOR = 2e-3
BWD_FRO_TOL = 1e-3


def _assert_bwd_close(got, want, name):
    a, b = got.float(), want.float()
    limit = _bf16_ulp(torch.maximum(a.abs(), b.abs())) + BWD_FLOOR * b.abs().max()
    assert bool(((a - b).abs() <= limit).all()), name
    assert (a - b).norm().item() <= BWD_FRO_TOL * b.norm().item(), name


# Edges of the tiling (128-row blocks, 64-row streamed tiles): causal with a
# ragged tile, Tq and Tk no multiples of either (100 x 300, 77 x 1500),
# Tq = 1, causal at 448 (the decoder's labels), and head-minor strides at
# d_model 1280 (whisper-large's 20 heads).
@pytest.mark.parametrize("B,H,Tq,Tk,causal", [
    (1, 2, 100, 100, True), (2, 3, 100, 300, False), (3, 4, 77, 1500, False),
    (2, 1, 1, 70, False), (2, 12, 448, 448, True), (1, 20, 130, 200, False)])
def test_flash_attention_backward_kernels_match_their_plain_versions(dev, B, H, Tq, Tk, causal):
    from sar_tpu_torch.ops import flash
    q, k, v, do = _k6_inputs(dev, B, H, Tq, Tk)
    o, lse = flash.flash_attention_fwd(q, k, v, causal=causal)
    di = (o.float() * do.float()).sum(-1).contiguous()
    args = (q, k, v, do, lse, di)
    pairs = [(flash.flash_attention_bwd_dq(*args, causal=causal),
              flash.flash_attention_bwd_dq_reference(*args, causal=causal))]
    pairs += zip(flash.flash_attention_bwd_dkv(*args, causal=causal),
                 flash.flash_attention_bwd_dkv_reference(*args, causal=causal))
    torch.cuda.synchronize()
    for name, (got, want) in zip(("dq", "dk", "dv"), pairs):
        _assert_bwd_close(got, want, name)


def test_flash_attention_kernels_with_one_key(dev):
    """Tk = 1, one ragged key tile: p = 1 on every row, so o is v's one row
    and lse the one score; dv (the column sum of do) is held as above. dq
    and dk are 0 in exact arithmetic (the softmax is constant), and both
    the kernels and the plain versions return the fp32 rounding noise of
    dp - di (two sums of the same 64 products in other orders, ~1e-6):
    each is held below 1e-4."""
    from sar_tpu_torch.ops import flash
    q, k, v, do = _k6_inputs(dev, 2, 2, 70, 1)
    o, lse = flash.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(o, v.expand_as(o))
    assert (lse - (q.float() * k.float()).sum(-1)).abs().max().item() <= 1e-5
    di = (o.float() * do.float()).sum(-1).contiguous()
    args = (q, k, v, do, lse, di)
    dk, dv = flash.flash_attention_bwd_dkv(*args)
    dq = flash.flash_attention_bwd_dq(*args)
    _, dv_plain = flash.flash_attention_bwd_dkv_reference(*args)
    torch.cuda.synchronize()
    _assert_bwd_close(dv, dv_plain, "dv")
    assert max(dq.float().abs().max().item(), dk.float().abs().max().item()) <= 1e-4


def test_flash_attention_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from sar_tpu_torch.ops import flash
    q, k, v, _ = _k6_inputs(dev, 1, 2, 64, 96)
    with pytest.raises(ValueError, match="bfloat16"):
        flash.flash_mha(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="causal"):
        flash.flash_mha(q, k, v, causal=True)
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_mha(q[..., :32], k[..., :32], v[..., :32])
    odd = torch.zeros((1, 2, 64, 68), dtype=torch.bfloat16, device=dev)[..., :64]
    with pytest.raises(ValueError, match="strides"):
        flash.flash_attention_fwd(odd, k, v)


def test_fp32_training_on_the_card_raises_unless_flash_is_off(dev):
    """flash_attention="auto" is K6 on the card whatever the dtype: an fp32
    run reaches the wrapper's bf16 check, which names the way out."""
    from sar_tpu_torch.data import SyntheticASRDataset, create_collator
    from sar_tpu_torch.models import lora as lora_lib
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.models.config import get_config
    from sar_tpu_torch.training import ASRTrainer, TrainingArgs
    cfg = dataclasses.replace(get_config("whisper-test"), d_model=128, encoder_heads=2,
                              decoder_heads=2, ffn_dim=256, max_source_positions=300)
    params = whisper.init_params(cfg, torch.Generator(device=dev).manual_seed(8), dev)
    lcfg = lora_lib.LoraConfig(r=8, alpha=16, dropout=0.0)
    bank = lora_lib.init_lora(torch.Generator(device=dev).manual_seed(9), cfg, lcfg)
    ds = SyntheticASRDataset(cfg, size=2, num_words=3, seed=0)
    batch = create_collator(cfg.sot_token_id, pad_to_length=24)([ds[i] for i in range(2)])
    fp32 = dict(mixed_precision="no", device=str(dev))
    with pytest.raises(ValueError, match="flash_attention off"):
        ASRTrainer(cfg, params, bank, lcfg, TrainingArgs(**fp32)).lora_grads(batch, None)
    tr = ASRTrainer(cfg, params, bank, lcfg, TrainingArgs(flash_attention="off", **fp32))
    loss, _ = tr.lora_grads(batch, None)
    assert torch.isfinite(loss)


def test_training_step_kernels_agree_with_the_plain_path(dev):
    """One bf16 LoRA training microbatch at d_model 128 (2 heads of 64)
    through ASRTrainer with K6 (every attention, forward and backward,
    under the selective checkpoint) and with exact attention: the losses
    within 1e-2 relative and every LoRA gradient at cosine >= 0.99 with
    norms within 5e-2 (bf16 rounding at other points in both)."""
    import numpy as np

    from sar_tpu_torch.data import SyntheticASRDataset, create_collator
    from sar_tpu_torch.models import lora as lora_lib
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.models.config import get_config
    from sar_tpu_torch.ops import flash
    from sar_tpu_torch.training import ASRTrainer, TrainingArgs
    from sar_tpu_torch.models.whisper import tree_leaves as leaves
    cfg = dataclasses.replace(get_config("whisper-test"), d_model=128, encoder_heads=2,
                              decoder_heads=2, ffn_dim=256, max_source_positions=300)
    params = whisper.cast_params(
        whisper.init_params(cfg, torch.Generator(device=dev).manual_seed(8), dev), torch.bfloat16)
    lcfg = lora_lib.LoraConfig(r=8, alpha=16, dropout=0.0)
    g = torch.Generator(device=dev).manual_seed(9)
    bank = lora_lib.init_lora(g, cfg, lcfg)
    for side in bank.values():
        for e in side.values():
            e["b"] = torch.randn(e["b"].shape, generator=g, device=dev) * 0.05
    ds = SyntheticASRDataset(cfg, size=4, num_words=3, seed=0)
    batch = create_collator(cfg.sot_token_id, pad_to_length=24)([ds[i] for i in range(4)])
    res = {}
    for mode in ("on", "off"):
        tr = ASRTrainer(cfg, params, bank, lcfg, TrainingArgs(flash_attention=mode, device=str(dev)))
        n = (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)
        loss, grads = tr.lora_grads(batch, None)
        torch.cuda.synchronize()
        launched = tuple(c - c0 for c, c0 in zip(
            (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES), n))
        n_attn = cfg.encoder_layers + 2 * cfg.decoder_layers
        assert launched == ((n_attn,) * 3 if mode == "on" else (0, 0, 0))
        res[mode] = (loss.item(), [x.float() for x in leaves(grads)])
    (lk, gk), (lp, gp) = res["on"], res["off"]
    assert np.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp)
    for a, b in zip(gk, gp):
        assert torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0) >= 0.99
        assert abs(a.norm() - b.norm()) <= 5e-2 * b.norm()


def _k8_inputs(dev, B, T, H, t_valid, seed=10, zero_bias=False):
    """A pre-LN residual with zero pad rows and one layer's LN and q/k/v
    parameters as cast_params leaves them (LN fp32, the rest bf16); with
    `zero_bias`, bq = bv = 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    D = H * 64
    x = _randn(g, dev, B, T, D)
    x[:, t_valid:] = 0
    ln = [1.0 + 0.1 * torch.randn(D, generator=g, device=dev),
          0.1 * torch.randn(D, generator=g, device=dev)]
    w = [_randn(g, dev, *s, std=0.05) for s in ((D, D), (D,), (D, D), (D, D), (D,))]
    if zero_bias:
        w[1].zero_()
        w[4].zero_()
    return x, ln[0], ln[1], *w


# K8: the smallest legal shapes (T_pad 64 and 128), whisper-small's width
# (12 heads) and whisper-medium's (16 heads; the route rule sends
# whisper-large to "hm"), T_pad 1536 with 36 pad rows, a T_pad whose last
# two 64-row tiles are all padding, and bq = bv = 0. Limit: 2e-2 absolute
# and relative to the largest entry (a bf16 rounding of q, k, v or p on the
# other side of a tie, as for K1).
@pytest.mark.parametrize("B,T,H,t_valid,zero_bias", [
    (2, 128, 2, 100, False), (2, 1536, 12, 1500, False), (1, 1536, 16, 1500, False),
    (2, 64, 2, 50, False), (1, 256, 16, 100, False), (2, 128, 12, 128, True)])
def test_encoder_attention_fused_kernel(dev, B, T, H, t_valid, zero_bias):
    from sar_tpu_torch.ops import flash_enc
    args = _k8_inputs(dev, B, T, H, t_valid, zero_bias=zero_bias)
    n1, n8 = flash_enc.LAUNCHES, flash_enc.FUSED_LAUNCHES
    got = flash_enc.encoder_attention_fused(*args, n_heads=H, t_valid=t_valid)
    want = flash_enc.encoder_attention_fused_reference(*args, n_heads=H, t_valid=t_valid)
    torch.cuda.synchronize()
    assert (flash_enc.LAUNCHES, flash_enc.FUSED_LAUNCHES) == (n1, n8 + 1)
    assert got.shape == args[0].shape and torch.isfinite(got.float()).all()
    err = (got[:, :t_valid].float() - want[:, :t_valid].float()).abs().max().item()
    assert err <= 2e-2 and err <= 2e-2 * want[:, :t_valid].float().abs().max().item()


# K8's LN + projection half alone against its plain version's q/k/v, every
# row (pad rows give h = the LN bias), in each configuration of
# LN_QKV_CONFIGS: 96 x 256 with 4 stages (D=768; at T_pad 192 with a tile
# of padding and bq = bv = 0) and 2 (D=1024), 64 x 256 (D=768 at T_pad 64),
# 64 x 128 (D=384 and 128), 64 x 64 (D=192, whole tiles of padding).
# Limit, per entry: one bf16 ulp
# of max(|kernel|, |plain|) (a sum on the other side of a rounding tie)
# plus 2e-3 of the plane's largest |plain| entry (the LN statistics sum in
# another fp32 order, which can move a bf16(h) by one ulp).
@pytest.mark.parametrize("B,T,H,t_valid,zero_bias", [
    (2, 1536, 12, 1500, False), (1, 1536, 16, 1500, False), (2, 64, 12, 50, False),
    (2, 128, 6, 128, False), (1, 256, 3, 100, False), (2, 192, 12, 60, True),
    (1, 192, 16, 100, True), (2, 64, 2, 50, False)])
def test_encoder_ln_qkv_kernel(dev, B, T, H, t_valid, zero_bias):
    from sar_tpu_torch.ops import flash_enc
    args = _k8_inputs(dev, B, T, H, t_valid, zero_bias=zero_bias)
    n1, n8, nh = flash_enc.LAUNCHES, flash_enc.FUSED_LAUNCHES, flash_enc.LN_QKV_LAUNCHES
    got = flash_enc.encoder_ln_qkv(*args, n_heads=H)
    want = flash_enc.encoder_ln_qkv_reference(*args, n_heads=H)
    torch.cuda.synchronize()
    assert (flash_enc.LAUNCHES, flash_enc.FUSED_LAUNCHES, flash_enc.LN_QKV_LAUNCHES) == (
        n1, n8, nh + 1)
    assert got.shape == (3, B, T, H * 64) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    for a, b in zip(got.float(), want.float()):
        slack = _bf16_ulp(torch.maximum(a.abs(), b.abs())) + 2e-3 * b.abs().max()
        assert ((a - b).abs() <= slack).all()


def test_encoder_attention_fused_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from sar_tpu_torch.ops import flash_enc
    x, lns, lnb, wq, bq, wk, wv, bv = _k8_inputs(dev, 1, 128, 2, 100)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_enc.encoder_attention_fused(x.float(), lns, lnb, wq, bq, wk, wv, bv,
                                          n_heads=2, t_valid=100)
    with pytest.raises(ValueError, match="float32"):
        flash_enc.encoder_attention_fused(x, lns.to(torch.bfloat16), lnb, wq, bq, wk, wv, bv,
                                          n_heads=2, t_valid=100)
    with pytest.raises(ValueError, match="head_dim"):
        flash_enc.encoder_attention_fused(x, lns, lnb, wq, bq, wk, wv, bv, n_heads=4,
                                          t_valid=100)
    with pytest.raises(ValueError, match="multiple"):
        flash_enc.encoder_attention_fused(x[:, :100].contiguous(), lns, lnb, wq, bq, wk, wv,
                                          bv, n_heads=2, t_valid=100)
    wide = _k8_inputs(dev, 1, 64, 32, 64)             # D = 2048: h does not fit
    for fn in (flash_enc.encoder_attention_fused, flash_enc.encoder_ln_qkv):
        kw = dict(t_valid=64) if fn is flash_enc.encoder_attention_fused else {}
        with pytest.raises(ValueError, match="more than the 232448"):
            fn(*wide, n_heads=32, **kw)


def _k9_inputs(dev, L, B, S, H, seed=11):
    """A head-minor int8 self cache and an s8 query, as K9 takes them."""
    from sar_tpu_torch.models import whisper
    g = torch.Generator(device=dev).manual_seed(seed)
    D = H * 64
    kq, ks = whisper.quantize_kv(torch.randn((L, B, S, H, 64), generator=g, device=dev))
    vq, vs = whisper.quantize_kv(torch.randn((L, B, S, H, 64), generator=g, device=dev))
    qq, qs = whisper.quantize_kv(torch.randn((B, H, 1, 64), generator=g, device=dev) * 0.125)
    return (qq[:, :, 0].reshape(B, D).contiguous(), qs.contiguous(),
            kq.reshape(L, B, S, D), ks.transpose(2, 3).contiguous(),
            vq.reshape(L, B, S, D), vs.transpose(2, 3).contiguous())


# K9: a ragged max_len (40) and whisper-small's (448, 12 heads, 12 layers of
# which the first and last are checked), valid lengths 1, a middle one and
# max_len, as an int and as a 0-d device tensor. Limit: as K7's, 1e-3
# absolute and 8e-3 relative to the largest entry (exact integer sums; the
# fp32 softmax sums in another order and can move a re-quantized
# probability across a .5 boundary).
@pytest.mark.parametrize("L,B,S,H", [(2, 3, 40, 2), (12, 8, 448, 12)])
def test_self_decode_kernel(dev, L, B, S, H):
    from sar_tpu_torch.ops.attic import decode_self
    args = _k9_inputs(dev, L, B, S, H)
    for layer in (0, L - 1):
        for n in (1, 23, S):
            for valid in (n, torch.tensor(n, dtype=torch.int32, device=dev)):
                c = decode_self.LAUNCHES
                got = decode_self.self_decode_attention(*args, valid, layer=layer, n_heads=H)
                want = decode_self.self_decode_reference(*args, n, layer=layer, n_heads=H)
                torch.cuda.synchronize()
                assert decode_self.LAUNCHES == c + 1
                assert got.shape == (B, H * 64) and got.dtype == torch.bfloat16
                err = (got.float() - want.float()).abs().max().item()
                assert err <= 1e-3 or err <= 8e-3 * want.float().abs().max().item()


# K9's cluster split at its edges: whisper's max_len 448 (2 slices of 224
# rows) at n = 0 (every row masked: uniform over all 448, every block reads
# its v), 100 (inside the first slice: rank 0 alone), 224 (a slice border:
# rank 0 alone), 225 (block 1 reads one row), 300 (inside the second
# slice) and 448; a ragged 40 (one block) at n = 0; 1500 (6 slices of 250)
# at n = 600, where blocks 3-5 read nothing; and 5000 (8 slices of 625 rows
# that stream through the v ring) inside a slice. Two runs give the same
# bits. Limit as test_self_decode_kernel's.
@pytest.mark.parametrize("S,n,C", [(448, 0, 2), (448, 100, 2), (448, 224, 2), (448, 225, 2),
                                   (448, 300, 2), (448, 448, 2), (40, 0, 1), (1500, 600, 6),
                                   (5000, 4321, 8)])
def test_self_decode_cluster_split_edges(dev, S, n, C):
    from sar_tpu_torch.ops.attic import decode_self
    assert decode_self.cluster_split(S)[0] == C
    L, B, H = 2, 3, 4
    args = _k9_inputs(dev, L, B, S, H, seed=14)
    got = decode_self.self_decode_attention(*args, n, layer=1, n_heads=H)
    again = decode_self.self_decode_attention(*args, torch.tensor(n, dtype=torch.int32,
                                                                  device=dev),
                                              layer=1, n_heads=H)
    want = decode_self.self_decode_reference(*args, n, layer=1, n_heads=H)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-3 or err <= 8e-3 * want.float().abs().max().item()


def test_self_decode_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from sar_tpu_torch.ops.attic import decode_self
    qq, qs, kq, ks, vq, vs = _k9_inputs(dev, 1, 2, 40, 2)
    with pytest.raises(ValueError, match="int8"):
        decode_self.self_decode_attention(qq.float(), qs, kq, ks, vq, vs, 5, layer=0, n_heads=2)
    with pytest.raises(ValueError, match="head_dim"):
        decode_self.self_decode_attention(qq, qs[:, :1].contiguous(), kq, ks[:, :, :1].contiguous(),
                                          vq, vs[:, :, :1].contiguous(), 5, layer=0, n_heads=1)
    with pytest.raises(ValueError, match="layer"):
        decode_self.self_decode_attention(qq, qs, kq, ks, vq, vs, 5, layer=1, n_heads=2)
    with pytest.raises(ValueError, match="bfloat16"):
        decode_self.self_decode_attention(qq, qs, kq, ks, vq, vs, 5, layer=0, n_heads=2,
                                          out_dtype=torch.float32)
    with pytest.raises(ValueError, match="valid_len"):
        decode_self.self_decode_attention(qq, qs, kq, ks, vq, vs, 41, layer=0, n_heads=2)


# K10: a ragged S (70), whisper-small's cross (S=1500, 12 heads, B=8),
# S = 1 (a cluster of one block), 1499 (no multiple of the 8 blocks), 4096
# (512-row slices stream through the 256-row v ring) and 58,080 (the
# longest the single-block kernel took); full and masked at 0 (the uniform
# softmax), 1, a middle length, a slice boundary and one past it, S; the
# length as an int and as a 0-d device tensor. Two runs give the same bits
# (no atomics). Limit: 2e-2 absolute and relative (bf16 probabilities and
# output; fp32 sums in another order).
@pytest.mark.parametrize("B,H,S", [(2, 3, 70), (8, 12, 1500), (2, 2, 1), (2, 3, 1499),
                                   (1, 2, 4096), (1, 2, 58_080)])
def test_decode_attention_kernel(dev, B, H, S):
    from sar_tpu_torch.ops.attic import attention
    g = torch.Generator(device=dev).manual_seed(12)
    q = _randn(g, dev, B, H, 64, std=0.125)
    k, v = _randn(g, dev, B, H, S, 64), _randn(g, dev, B, H, S, 64)
    rows = attention.cluster_split(S)[1]
    lengths = sorted({n for n in (0, 1, 37, rows, rows + 1, S) if n <= S})
    as_tensor = [torch.tensor(n, dtype=torch.int32, device=dev) for n in (min(37, S), rows)]
    for valid in [None, *lengths, *as_tensor]:
        c = attention.LAUNCHES
        got = attention.decode_attention(q, k, v, valid)
        again = attention.decode_attention(q, k, v, valid)
        want = attention.decode_attention_reference(q, k, v, valid)
        torch.cuda.synchronize()
        assert attention.LAUNCHES == c + 2
        assert got.shape == q.shape and got.dtype == torch.bfloat16
        assert torch.equal(got, again)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 and err <= 2e-2 * max(want.float().abs().max().item(), 1.0)


def test_decode_attention_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from sar_tpu_torch.ops.attic import attention
    q = torch.zeros((2, 3, 64), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((2, 3, 70, 64), dtype=torch.bfloat16, device=dev)
    long = torch.zeros((1, 1, 400_000, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="shared memory per block"):
        attention.decode_attention(q[:1, :1], long, long)
    with pytest.raises(ValueError, match="bfloat16"):
        attention.decode_attention(q.float(), k.float(), k.float())
    with pytest.raises(ValueError, match="head_dim"):
        attention.decode_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                                   k[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        attention.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), k)


def _tie_case(dev, L, B, S, H, n_valid, seed):
    """An s8 cache whose valid rows tie to rounding: per (layer, sample,
    head) every row holds the same k bytes, so the scores differ only by
    the k scales, which sit within 3 ulps of each other (and are small, so
    exp(s - M) is near 1 for every row); every 5th valid
    row (spread over every slice of the cluster) has a v scale within 3
    ulps of one value, the others 0.2-0.9 of it. The |pw| of those rows
    then tie to rounding across blocks and within a block. Rows past
    n_valid carry scale 0 (K7's layout padding). Returns the K7/K9
    operands kq, ks, vq, vs on `dev`."""
    g = torch.Generator().manual_seed(seed)
    D = H * 64
    ulp = 2.0 ** -23
    krow = torch.randint(-127, 128, (L, B, 1, D), generator=g, dtype=torch.int8)
    kq = krow.expand(L, B, S, D).contiguous()
    vq = torch.randint(-127, 128, (L, B, S, D), generator=g, dtype=torch.int8)
    jitter = lambda: torch.randint(-3, 4, (L, B, H, S), generator=g).float() * ulp
    ks = 1e-3 * (1 + jitter())                  # small scores: exp(s - M) near 1
    top = (torch.arange(S) % 5 == 0)
    vs = torch.where(top, 0.05 * (1 + jitter()),
                     0.05 * (0.2 + 0.7 * torch.rand((L, B, H, S), generator=g)))
    ks[..., n_valid:] = 0
    vs[..., n_valid:] = 0
    return kq.to(dev), ks.to(dev), vq.to(dev), vs.to(dev)


def _assert_exact_scale(out, pw, pq, ps, want, n_valid, C):
    """ps = max(max_s |pw_s|, 1e-8) / 127 of the kernel's own pw and pq =
    clamp(rint(pw / ps)) bit for bit (fp32 on the host, round half to
    even: the plain version's quantization); the rows do tie to rounding
    (several entries within 2^-20 of the largest |pw|, in more than one
    slice when C > 1); the output within K7/K9's limits."""
    pw, pq, ps = pw.cpu(), pq.cpu(), ps.cpu()
    want_ps = pw.abs().amax(-1).clamp_min(1e-8) / 127.0
    assert torch.equal(ps, want_ps)
    want_pq = torch.clamp(torch.round(pw / ps[..., None]), -127, 127).to(torch.int8)
    assert torch.equal(pq[..., :n_valid], want_pq[..., :n_valid])
    assert not pq[..., n_valid:].any()
    a = pw.abs()
    near = a >= a.amax(-1, keepdim=True) * (1 - 2.0 ** -20)
    assert (near.sum(-1) >= 2).float().mean() >= 0.5
    if C > 1:
        slice_rows = -(-pw.shape[-1] // C)
        first = near.float().argmax(-1)
        last = pw.shape[-1] - 1 - near.flip(-1).float().argmax(-1)
        assert ((last // slice_rows) != (first // slice_rows)).float().mean() >= 0.5
    err = (out.float() - want.float()).abs().max().item()
    assert err <= 1e-3 or err <= 8e-3 * want.float().abs().max().item()


# K7's re-quantization scale on rows that tie to rounding (ROADMAP's Queue
# C 1, repaired): at whisper-small's width, S_pad 1536 (3 slices of 512)
# with 1500 valid rows, K = 1, 4 and 8, every layer of a 2-layer cache.
@pytest.mark.parametrize("K", [1, 4, 8])
def test_cross_decode_s8_scale_is_the_exact_max_on_ties(dev, K):
    from sar_tpu_torch.ops import decode_cross
    L, B, H, S_pad, S = 2, 2, 12, 1536, 1500
    kq, ks, vq, vs = _tie_case(dev, L, B, S_pad, H, S, seed=K)
    g = torch.Generator(device=dev).manual_seed(21)
    qq, qs = _s8_query(g, dev, B, K, H, folded=K > 1)
    C = decode_cross.s8_cluster_split(S_pad)[0]
    for layer in range(L):
        n = (decode_cross.S8_LAUNCHES, decode_cross.S8_BEAM_LAUNCHES)
        out, pw, pq, ps = decode_cross.s8_decode_probe(qq, qs, kq, ks, vq, vs, layer=layer,
                                                       n_heads=H)
        got = decode_cross.cross_decode_attention(qq, qs, kq, ks, vq, vs, layer=layer,
                                                  n_heads=H)
        want = decode_cross.cross_decode_reference(qq, qs, kq, ks, vq, vs, layer=layer,
                                                   n_heads=H)
        torch.cuda.synchronize()
        assert torch.equal(out, got)            # the probe is the same kernel
        assert (decode_cross.S8_LAUNCHES + decode_cross.S8_BEAM_LAUNCHES) == sum(n) + 1
        _assert_exact_scale(out, pw, pq, ps, want.reshape(out.shape), S, C)


# K9's: whisper's max_len 448 (2 slices of 224) at n = 448 and 300 (both
# blocks) and 100 (rank 0 alone), 12 heads.
@pytest.mark.parametrize("n", [448, 300, 100])
def test_self_decode_scale_is_the_exact_max_on_ties(dev, n):
    from sar_tpu_torch.ops import decode_cross
    from sar_tpu_torch.ops.attic import decode_self
    L, B, H, S = 2, 3, 12, 448
    kq, ks, vq, vs = _tie_case(dev, L, B, S, H, S, seed=n)
    g = torch.Generator(device=dev).manual_seed(22)
    qq, qs = _s8_query(g, dev, B, 1, H, folded=False)
    qs = qs.reshape(B, H, 1)
    C = decode_self.cluster_split(S)[0] if n > S // 2 else 1
    for layer in range(L):
        out, pw, pq, ps = decode_cross.s8_decode_probe(qq, qs, kq, ks, vq, vs, layer=layer,
                                                       n_heads=H, valid_len=n)
        got = decode_self.self_decode_attention(qq, qs, kq, ks, vq, vs, n, layer=layer,
                                                n_heads=H)
        want = decode_self.self_decode_reference(qq, qs, kq, ks, vq, vs, n, layer=layer,
                                                 n_heads=H)
        torch.cuda.synchronize()
        assert torch.equal(out, got)
        _assert_exact_scale(out.reshape(B, 1, H * 64), pw, pq, ps, want.reshape(B, 1, H * 64),
                            n, C)
