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


# Shapes: the smallest legal one, whisper-small's and whisper-large-v3's
# widths (the kernels need no column groups at d_model 1280).
@pytest.mark.parametrize("B,T,H,t_valid", [(2, 128, 2, 100), (1, 1536, 12, 1500),
                                           (1, 1536, 20, 1500)])
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


@pytest.mark.parametrize("H", [4, 20])
def test_cross_decode_kernel(dev, H):
    from sar_tpu_torch.ops import decode_cross, kv_init
    g = torch.Generator(device=dev).manual_seed(2)
    L, B, S, S_pad = 2, 3, 100, 128
    D = H * 64
    x = _randn(g, dev, B, S_pad, D)
    x[:, S:] = 0
    w = _randn(g, dev, L, D, D, std=0.05)
    kq, ks, vq, vs = kv_init.fused_kv_init_reference(
        x, w, w, torch.zeros((L, D), dtype=torch.bfloat16, device=dev), n_heads=H, t_valid=S)
    q = _randn(g, dev, B, D, std=0.125)
    for layer in range(L):
        got = decode_cross.cross_decode_attention_exact(q, kq, ks, vq, vs, layer=layer, n_heads=H)
        want = decode_cross.cross_decode_reference_exact(q, kq, ks, vq, vs, layer=layer, n_heads=H)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= 2e-2


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
    big = torch.zeros((L, B, 7296, H * 64), dtype=torch.int8, device=dev)
    bigs = torch.ones((L, B, H, 7296), device=dev)
    q = torch.zeros((B, 8, H * 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="shared"):
        decode_cross.cross_decode_attention_exact(q, big, bigs, big, bigs, layer=0, n_heads=H)


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
    # 8 rows of 5824 fp32 scores and s8 probabilities: 232,960 B > one block.
    big = torch.zeros((L, B, 5824, H * 64), dtype=torch.int8, device=dev)
    bigs = torch.ones((L, B, H, 5824), device=dev)
    qq, qs = _s8_query(g, dev, B, 8, H, folded=True)
    with pytest.raises(ValueError, match="shared"):
        decode_cross.cross_decode_attention(qq, qs, big, bigs, big, bigs, layer=0, n_heads=H)


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
    with pytest.raises(ValueError, match="multiple"):
        flash_enc.encoder_attention_hm(q, q, q, n_heads=2, t_valid=100)


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


# The dQ and dK/dV kernels against their own plain versions, given the same
# lse and di: both sum the same bf16 products in fp32 in the same order
# (chip_smoke.py reads 0 at the whisper-small shapes), so the limit is
# 1e-3 of the largest entry, under one bf16 ulp of it (3.9e-3 to 7.8e-3).
@pytest.mark.parametrize("B,H,Tq,Tk,causal", [
    (1, 2, 100, 100, True), (2, 3, 100, 300, False), (3, 4, 77, 1500, False)])
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
    for got, want in pairs:
        assert _rel(got, want) <= 1e-3


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


def _k8_inputs(dev, B, T, H, t_valid, seed=10):
    """A pre-LN residual with zero pad rows and one layer's LN and q/k/v
    parameters as cast_params leaves them (LN fp32, the rest bf16)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    D = H * 64
    x = _randn(g, dev, B, T, D)
    x[:, t_valid:] = 0
    ln = [1.0 + 0.1 * torch.randn(D, generator=g, device=dev),
          0.1 * torch.randn(D, generator=g, device=dev)]
    w = [_randn(g, dev, *s, std=0.05) for s in ((D, D), (D,), (D, D), (D, D), (D,))]
    return x, ln[0], ln[1], *w


# K8: the smallest legal shape, whisper-small's width (12 heads) and
# whisper-medium's (16 heads; the route rule sends whisper-large to "hm"),
# T_pad 1536 with 36 pad rows. Limit: 2e-2 absolute and relative to the
# largest entry (a bf16 rounding of q, k, v or p on the other side of a
# tie, as for K1).
@pytest.mark.parametrize("B,T,H,t_valid", [(2, 128, 2, 100), (2, 1536, 12, 1500),
                                           (1, 1536, 16, 1500)])
def test_encoder_attention_fused_kernel(dev, B, T, H, t_valid):
    from sar_tpu_torch.ops import flash_enc
    args = _k8_inputs(dev, B, T, H, t_valid)
    n1, n8 = flash_enc.LAUNCHES, flash_enc.FUSED_LAUNCHES
    got = flash_enc.encoder_attention_fused(*args, n_heads=H, t_valid=t_valid)
    want = flash_enc.encoder_attention_fused_reference(*args, n_heads=H, t_valid=t_valid)
    torch.cuda.synchronize()
    assert (flash_enc.LAUNCHES, flash_enc.FUSED_LAUNCHES) == (n1, n8 + 1)
    assert got.shape == args[0].shape and torch.isfinite(got.float()).all()
    err = (got[:, :t_valid].float() - want[:, :t_valid].float()).abs().max().item()
    assert err <= 2e-2 and err <= 2e-2 * want[:, :t_valid].float().abs().max().item()


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


# K10: a ragged S (70) and whisper-small's cross (S=1500, 12 heads, B=8),
# full and masked (1, a middle length, S), the length as an int and as a
# 0-d device tensor. Limit: 2e-2 absolute and relative (bf16 probabilities
# and output; fp32 sums in another order).
@pytest.mark.parametrize("B,H,S", [(2, 3, 70), (8, 12, 1500)])
def test_decode_attention_kernel(dev, B, H, S):
    from sar_tpu_torch.ops.attic import attention
    g = torch.Generator(device=dev).manual_seed(12)
    q = _randn(g, dev, B, H, 64, std=0.125)
    k, v = _randn(g, dev, B, H, S, 64), _randn(g, dev, B, H, S, 64)
    for valid in (None, 1, 37, S, torch.tensor(37, dtype=torch.int32, device=dev)):
        c = attention.LAUNCHES
        got = attention.decode_attention(q, k, v, valid)
        want = attention.decode_attention_reference(q, k, v, valid)
        torch.cuda.synchronize()
        assert attention.LAUNCHES == c + 1
        assert got.shape == q.shape and got.dtype == torch.bfloat16
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2e-2 and err <= 2e-2 * max(want.float().abs().max().item(), 1.0)


def test_decode_attention_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from sar_tpu_torch.ops.attic import attention
    q = torch.zeros((2, 3, 64), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((2, 3, 70, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        attention.decode_attention(q.float(), k.float(), k.float())
    with pytest.raises(ValueError, match="head_dim"):
        attention.decode_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                                   k[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        attention.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), k)
