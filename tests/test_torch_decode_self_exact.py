"""K11, the int8 self-attention decode kernel (sar_tpu_torch/ops/
decode_self_exact.py, csrc/decode_self_exact.cu), and decode_step's
dispatch to it.

CPU cases: the wrapper on CPU tensors is `whisper._attention_int8` over the
same slice of the stacked self cache, bit for bit, at the segment edges (pos
0, pos = n - 1, n = max_len), and within 1e-5 of the JAX package's
`_attention_int8`; `decode_step` sends a classic int8 self side through the
wrapper (kernels=True, no `scores_int8`, no `ancestry`) with the step's
layer, pos and self_len, and never an s8, int4, plain or ancestry self side
or the classic int8 cross side; the launch counter stays put on the CPU.

`cuda`-marked cases (skipped without a card): K11 against its plain version
in bf16 at whisper-small B=8 and B=128 (12 heads) and large-v3-turbo B=64
(20 heads), n in {32, 100, 228, 448}, pos in {0, n // 2, n - 1}, scales that
include zeros; rows past pos left unread; a captured greedy run with
kernels=True against kernels=False, tokens equal; the wrapper refusing
what the kernel does not take. This file imports no JAX at module level,
so the card runs it with
`python -m pytest tests/test_torch_decode_self_exact.py -m cuda -q --noconftest`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import get_config
from sar_tpu_torch.ops import decode_self_exact as dse

CFG = get_config("whisper-test")
INT8 = dict(cross_kv_int8=True, self_kv_int8=True)


def _self_cache(g, L, B, H, T, hd, device="cpu", zero_scales=False):
    """A stacked int8 self cache (values and per-row scales by quantize_kv);
    with zero_scales, every 5th K row and 7th V row carry scale 0."""
    kq, ks = whisper.quantize_kv(torch.randn((L, B, H, T, hd), generator=g, device=device))
    vq, vs = whisper.quantize_kv(torch.randn((L, B, H, T, hd), generator=g, device=device))
    if zero_scales:
        ks[..., ::5] = 0.0
        vs[..., ::7] = 0.0
    return kq, ks, vq, vs


# (layer, pos, n) at T = 12 rows: the first position, pos = n - 1 inside a
# segment, n = max_len, and a middle one.
EDGES = [(0, 0, 1), (1, 0, 12), (1, 5, 6), (0, 11, 12), (1, 3, 8)]


@pytest.mark.parametrize("q_form", ["heads", "flat"])
@pytest.mark.parametrize("layer,pos,n", EDGES)
def test_wrapper_is_attention_int8_on_the_slice(layer, pos, n, q_form):
    g = torch.Generator().manual_seed(layer * 100 + pos * 10 + n)
    L, B, H, T, hd = 2, 3, 2, 12, 16
    kq, ks, vq, vs = _self_cache(g, L, B, H, T, hd, zero_scales=True)
    q = torch.randn((B, H, 1, hd), generator=g) * hd ** -0.5
    before = dse.LAUNCHES
    got = dse.self_decode_attention_exact(q if q_form == "heads" else q.reshape(B, H * hd),
                                          kq, ks, vq, vs, layer=layer, pos=pos, n=n)
    mask = (torch.arange(n) <= pos)[None, None, None, :]
    want = whisper._attention_int8(q, kq[layer, :, :, :n], ks[layer, :, :, :n],
                                   vq[layer, :, :, :n], vs[layer, :, :, :n], mask=mask)
    assert dse.LAUNCHES == before
    assert got.shape == (B, H, 1, hd) and torch.equal(got, want)


@pytest.mark.parametrize("layer,pos,n", EDGES[:3])
def test_wrapper_matches_the_jax_self_path(layer, pos, n):
    import jax.numpy as jnp

    from sar_tpu.models import whisper as jw
    rng = np.random.default_rng(pos + n)
    L, B, H, T, hd = 2, 3, 2, 12, 16
    kq = rng.integers(-127, 128, (L, B, H, T, hd), dtype=np.int8)
    vq = rng.integers(-127, 128, (L, B, H, T, hd), dtype=np.int8)
    ks, vs = (rng.uniform(0, 0.02, (L, B, H, T)).astype(np.float32) for _ in range(2))
    q = (rng.standard_normal((B, H, 1, hd)) * hd ** -0.5).astype(np.float32)
    got = dse.self_decode_attention_exact(*map(torch.from_numpy, (q, kq, ks, vq, vs)),
                                          layer=layer, pos=pos, n=n)
    mask = (np.arange(n) <= pos)[None, None, None, :]
    want = jw._attention_int8(jnp.asarray(q), jnp.asarray(kq[layer, :, :, :n]),
                              jnp.asarray(ks[layer, :, :, :n]), jnp.asarray(vq[layer, :, :, :n]),
                              jnp.asarray(vs[layer, :, :, :n]), mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def model():
    params = whisper.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    enc = torch.randn((2, CFG.max_source_positions, CFG.d_model),
                      generator=torch.Generator().manual_seed(1))
    return params, enc


# (cache flags, decode_step options, beam width, whether the self side
# reaches the wrapper). Beams: 2 per sample, with an identity ancestry or
# over a physically reordered self cache.
DISPATCH = {
    "int8-head-minor": (INT8, {}, 1, True),
    "int8-classic": (dict(INT8, head_minor=False), {}, 1, True),
    "plain-cross-int8-self": (dict(self_kv_int8=True), {}, 1, True),
    "int8-beam-reorder": (INT8, {}, 2, True),
    "kernels-off": (INT8, dict(kernels=False), 1, False),
    "scores-int8": (INT8, dict(scores_int8=True), 1, False),
    "int4-self": (dict(cross_kv_int8=True, self_kv_int4=True), {}, 1, False),
    "plain-self": (dict(cross_kv_int8=True), {}, 1, False),
    "int8-beam-ancestry": (INT8, dict(ancestry=True), 2, False),
}


@pytest.mark.parametrize("case", DISPATCH)
def test_decode_step_dispatch(model, monkeypatch, case):
    """The wrapper sees one call per layer of each step, with its layer, pos
    and self_len, exactly on the paths the kernel serves, and never with
    kernels=False; the logits equal the kernels=False steps' bit for bit
    (on the CPU the wrapper runs `_attention_int8`); the classic int8 cross
    side never reaches it."""
    params, enc = model
    flags, opts, K, reaches = DISPATCH[case]
    B, max_len, pos, self_len, L = enc.shape[0], 12, 3, 8, CFG.decoder_layers
    calls, wrapper = [], whisper.self_decode_attention_exact

    def recorder(*args, **kwargs):
        calls.append((kwargs["layer"], kwargs["pos"], kwargs["n"]))
        return wrapper(*args, **kwargs)
    monkeypatch.setattr(whisper, "self_decode_attention_exact", recorder)
    kw = dict(opts)
    kernels = kw.pop("kernels", True)
    if kw.pop("ancestry", False):
        kw["ancestry"] = torch.arange(K)[None, :, None].expand(B, K, max_len).contiguous()
    tok = torch.arange(B * K) + 5

    def steps(kernels):
        cache = whisper.init_cache(params, enc, CFG, max_len, self_batch=B * K, **flags)
        for p in range(pos + 1):
            logits, cache = whisper.decode_step(params, tok, p, cache, CFG, beam_width=K,
                                                self_len=self_len, kernels=kernels, **kw)
        return logits
    before = dse.LAUNCHES
    got = steps(kernels)
    assert len(calls) == ((pos + 1) * L if reaches else 0)
    if reaches:
        assert calls[-L:] == [(l, pos, self_len) for l in range(L)]
    n_calls = len(calls)
    want = steps(False)
    assert len(calls) == n_calls
    assert torch.equal(got, want)
    assert dse.LAUNCHES == before


# ---------------------------------------------------------------------------
# On the card.

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# (B, H) of whisper-small's serving batch and evaluation batch, and
# large-v3-turbo's evaluation batch; a self cache of Whisper's 448 rows.
SHAPES = {"small-b8": (8, 12), "small-b128": (128, 12), "turbo-b64": (64, 20)}
T_MAX = 448


@pytest.fixture(scope="module")
def caches(dev):
    g = torch.Generator(device=dev).manual_seed(11)
    return {name: _self_cache(g, 2, B, H, T_MAX, 64, device=dev, zero_scales=True)
            for name, (B, H) in SHAPES.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("n", [32, 100, 228, 448])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_its_plain_version(dev, caches, shape, n, where):
    B, H = SHAPES[shape]
    pos = {"first": 0, "middle": n // 2, "last": n - 1}[where]
    cache = caches[shape]
    g = torch.Generator(device=dev).manual_seed(n + pos)
    q = (torch.randn((B, H, 1, 64), generator=g, device=dev) * 0.125).to(torch.bfloat16)
    before = dse.LAUNCHES
    got = dse.self_decode_attention_exact(q, *cache, layer=1, pos=pos, n=n)
    want = dse.self_decode_reference_exact(q, *cache, layer=1, pos=pos, n=n)
    torch.cuda.synchronize()
    assert dse.LAUNCHES == before + 1
    assert got.shape == want.shape == (B, H, 1, 64) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 and err <= 2e-2 * want.float().abs().max().item()


@pytest.mark.cuda
def test_kernel_reads_no_row_past_pos(dev):
    """Garbage past pos (NaN scales, random values) leaves the output
    unchanged: the kernel does not read those rows."""
    g = torch.Generator(device=dev).manual_seed(5)
    kq, ks, vq, vs = _self_cache(g, 1, 8, 12, T_MAX, 64, device=dev)
    q = (torch.randn((8, 12, 1, 64), generator=g, device=dev) * 0.125).to(torch.bfloat16)
    pos = 57
    want = dse.self_decode_attention_exact(q, kq, ks, vq, vs, layer=0, pos=pos, n=T_MAX)
    ks[..., pos + 1:] = float("nan")
    vs[..., pos + 1:] = float("nan")
    kq[..., pos + 1:, :] = 127
    got = dse.self_decode_attention_exact(q, kq, ks, vq, vs, layer=0, pos=pos, n=T_MAX)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(dev):
    L, B, H, T = 1, 2, 2, 16
    kq = torch.zeros((L, B, H, T, 32), dtype=torch.int8, device=dev)
    ks = torch.ones((L, B, H, T), device=dev)
    q = torch.zeros((B, H, 1, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim 64"):
        dse.self_decode_attention_exact(q, kq, ks, kq, ks, layer=0, pos=0, n=T)
    kq = torch.zeros((L, B, H, T, 64), dtype=torch.int8, device=dev)
    q = torch.zeros((B, H, 1, 64), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        dse.self_decode_attention_exact(q, kq, ks, kq, ks, layer=0, pos=0, n=T)
    with pytest.raises(ValueError, match="int8"):
        dse.self_decode_attention_exact(q.to(torch.bfloat16), kq.float(), ks, kq, ks,
                                        layer=0, pos=0, n=T)
    big = torch.zeros((L, B, H, T_MAX + 1, 64), dtype=torch.int8, device=dev)
    bigs = torch.ones((L, B, H, T_MAX + 1), device=dev)
    with pytest.raises(ValueError, match="448"):
        dse.self_decode_attention_exact(q.to(torch.bfloat16), big, bigs, big, bigs,
                                        layer=0, pos=0, n=T_MAX + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["int8-head-minor", "int8-classic"])
def test_captured_greedy_kernel_equals_plain(dev, cache):
    """A captured greedy run (K11 in every step's graph) gives the tokens of
    the plain path (kernels=False, eager), and K11 counts one launch per
    layer of every step run, replays included."""
    from sar_tpu_torch.decode import segments
    from sar_tpu_torch.decode.graphs import CudaGraphCapture, DecodeRunner
    cfg = dataclasses.replace(CFG, d_model=128, encoder_heads=2, decoder_heads=2, ffn_dim=256)
    params = whisper.cast_params(
        whisper.init_params(cfg, torch.Generator(device=dev).manual_seed(6), dev), torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(7)
    encs = [torch.randn((3, cfg.max_source_positions, cfg.d_model), generator=g,
                        device=dev).to(torch.bfloat16) for _ in range(2)]
    flags = INT8 if cache == "int8-head-minor" else dict(INT8, head_minor=False)
    prompt, total = cfg.prompt_ids("english"), 4 + 20
    cap = DecodeRunner(params, cfg, capture=CudaGraphCapture)
    plain = DecodeRunner(params, cfg, kernels=False)
    for e in (encs[0], encs[1], encs[0]):
        before, steps = dse.LAUNCHES, sum(segments.STEPS.values())
        got = cap.greedy(cap.prep(e, total, **flags), prompt, segment=8)
        torch.cuda.synchronize()
        run = sum(segments.STEPS.values()) - steps
        assert run > 0 and dse.LAUNCHES - before == cfg.decoder_layers * run
        want = plain.greedy(plain.prep(e, total, **flags), prompt, segment=8)
        assert torch.equal(got, want)
