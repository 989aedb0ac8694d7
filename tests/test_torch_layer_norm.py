"""K13, the LayerNorm of bf16 rows with fp32 parameters, and K14, the
residual add and LayerNorm of a decoder sublayer boundary
(sar_tpu_torch/ops/layer_norm.py, csrc/layer_norm.cu), whose plain versions
are `layer_norm_reference` (`models/whisper.py::layer_norm` too) and
`add_layer_norm_reference` there.

CPU cases: the wrappers on CPU tensors are the plain versions, bit for bit,
and move no launch counter; `add_layer_norm_reference` is the unfused
chain (`whisper.linear`'s bias add, the residual add, the LayerNorm) bit
for bit; `whisper.decode_step` at whisper-small's and OWSM's decoder widths
sends its first LayerNorm through `layer_norm` and each of its 3L sublayer
boundaries through `add_layer_norm`, the bias folded in where no LoRA term
follows it, and gives the plain chain's logits and cache bit for bit
(kernels=False and fp32 compute never reach the wrappers).

`cuda`-marked cases (skipped without a card): the kernel against its plain
version in bf16 at OWSM v4 medium's shapes (B=128, T 768, D 1024; the
cgMLP gate's D 2048 read as the second half of a [.., 4096] activation;
the first 749 frames of a padded batch, read in place) and ragged ones;
K14 against its plain version at B 8 and 128, D 768, 1024 and 1280, with
and without the bias (x_new bit-equal, h within K13's tolerance); the
wrappers refusing what the kernels do not take. This file imports no JAX,
so the card runs it with
`python -m pytest tests/test_torch_layer_norm.py -m cuda -q --noconftest`.
"""

import dataclasses

import pytest
import torch

from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import get_config
from sar_tpu_torch.ops import layer_norm as ln_ops


def _params(g, D, device="cpu"):
    return (1.0 + 0.1 * torch.randn((D,), generator=g, device=device),
            0.1 * torch.randn((D,), generator=g, device=device))


def test_wrapper_on_cpu_is_the_plain_version():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 9, 512), generator=g)
    scale, bias = _params(g, 512)
    before = ln_ops.LAUNCHES
    got = ln_ops.layer_norm(x[:, 1:], scale, bias, 1e-12)
    assert torch.equal(got, ln_ops.layer_norm_reference(x[:, 1:], scale, bias, 1e-12))
    assert ln_ops.LAUNCHES == before


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("D", [768, 1024, 1280])
@pytest.mark.parametrize("with_bias", [True, False])
def test_add_reference_is_the_unfused_chain(with_bias, D, eps):
    """`linear`'s bias add, then the residual add, then the LayerNorm, in
    bf16 rows as a decoder step holds them; the wrapper on the CPU is the
    plain version and launches nothing."""
    g = torch.Generator().manual_seed(D + with_bias)
    x = (3.0 * torch.randn((5, 1, D), generator=g)).to(torch.bfloat16)
    h_in = torch.randn((5, 1, D), generator=g).to(torch.bfloat16)
    w = (0.05 * torch.randn((D, D), generator=g)).to(torch.bfloat16)
    b = torch.randn((D,), generator=g).to(torch.bfloat16) if with_bias else None
    scale, bias = _params(g, D)
    proj = {"w": w, **({"b": b} if with_bias else {})}
    x_want = x + whisper.linear(h_in, proj)
    h_want = ln_ops.layer_norm_reference(x_want, scale, bias, eps)
    before = ln_ops.ADD_LAUNCHES
    for fn in (ln_ops.add_layer_norm_reference, ln_ops.add_layer_norm):
        x_new, h = fn(x, torch.matmul(h_in, w), b, scale, bias, eps)
        assert x_new.dtype == h.dtype == torch.bfloat16
        assert torch.equal(x_new, x_want) and torch.equal(h, h_want)
    assert ln_ops.ADD_LAUNCHES == before


def _decoder_config(kind):
    """whisper-test with whisper-small's or OWSM v4 medium's decoder widths
    (OWSM's ReLU and LayerNorm eps), two layers, a small vocabulary."""
    widths = {"whisper-small": dict(d_model=768, decoder_heads=12, ffn_dim=3072),
              "owsm": dict(d_model=1024, decoder_heads=16, ffn_dim=4096,
                           decoder_act="relu", ln_eps=1e-12)}[kind]
    return dataclasses.replace(get_config("whisper-test"), encoder_layers=1,
                               encoder_heads=4, max_source_positions=16,
                               vocab_size=512, **widths)


@pytest.fixture(scope="module")
def decoders():
    """Per config: bf16 parameters with every decoder leaf perturbed (init's
    biases are 0; here each bias and LayerNorm parameter is not), their fp32
    twin, and an encoder output."""
    out = {}
    for kind in ("whisper-small", "owsm"):
        cfg = _decoder_config(kind)
        g = torch.Generator().manual_seed(len(kind))
        params = whisper.init_params(cfg, g, "cpu")
        params["decoder"] = whisper.tree_map(
            lambda t: t + 0.05 * torch.randn(t.shape, generator=g) if t.is_floating_point()
            else t, params["decoder"])
        enc = torch.randn((3, cfg.max_source_positions, cfg.d_model), generator=g)
        out[kind] = (cfg, params, whisper.cast_params(params, torch.bfloat16), enc)
    return out


# LoRA hooks of the decoder bank: none, the served cell's (q and v), and
# hooks on the output projections, where the bias cannot be folded.
HOOKS = {"none": (), "q-v": ("self_q", "self_v", "cross_q"), "o": ("self_o", "cross_o")}


@pytest.mark.parametrize("variant", ["bf16", "q-v", "o", "fp32"])
@pytest.mark.parametrize("kind", ["whisper-small", "owsm"])
def test_decode_step_routes_its_boundaries(decoders, monkeypatch, kind, variant):
    cfg, params32, params16, enc = decoders[kind]
    params = params32 if variant == "fp32" else params16
    dtype = params["decoder"]["token_embed"].dtype
    L, d, B, max_len = cfg.decoder_layers, cfg.d_model, enc.shape[0], 6
    g = torch.Generator().manual_seed(7)
    hooks = HOOKS.get(variant, ())
    lora = {"decoder": {k: {"a": (0.1 * torch.randn((L, 2, d, 4), generator=g)).to(dtype),
                            "b": (0.1 * torch.randn((L, 2, 4, d), generator=g)).to(dtype)}
                        for k in hooks}} if hooks else None
    adapter_idx = torch.tensor([0, 1, 1]) if hooks else None
    calls, k13 = [], []
    add_ln, ln = ln_ops.add_layer_norm, ln_ops.layer_norm

    def add_recorder(x, y, b, *args):
        calls.append(b is not None)
        return add_ln(x, y, b, *args)

    def ln_recorder(*args):
        k13.append(1)
        return ln(*args)
    monkeypatch.setattr(ln_ops, "add_layer_norm", add_recorder)
    monkeypatch.setattr(ln_ops, "layer_norm", ln_recorder)

    n_steps = 3

    def steps(kernels):
        cache = whisper.init_cache(params, enc.to(dtype), cfg, max_len, cross_kv_int8=True,
                                   self_kv_int8=True)
        tok = torch.tensor([5, 9, 17])
        for pos in range(n_steps):
            logits, cache = whisper.decode_step(params, tok + pos, pos, cache, cfg, lora=lora,
                                                adapter_idx=adapter_idx, kernels=kernels)
        return logits, cache
    before = (ln_ops.LAUNCHES, ln_ops.ADD_LAUNCHES)
    got_logits, got_cache = steps(True)
    if variant == "fp32":
        assert calls == [] and k13 == []
    else:
        folded = [hook not in hooks for hook in ("self_o", "cross_o", "fc2")]
        assert calls == folded * (L * n_steps) and len(k13) == n_steps
    n = len(calls), len(k13)
    want_logits, want_cache = steps(False)
    assert (len(calls), len(k13)) == n
    assert torch.equal(got_logits, want_logits)
    for a, b in zip(got_cache, want_cache):
        assert (a is None and b is None) or torch.equal(a, b)
    assert (ln_ops.LAUNCHES, ln_ops.ADD_LAUNCHES) == before


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _view(x, kind):
    return {"whole": x, "second-half": x[..., x.shape[-1] // 2:],
            "first-frames": x[:, :x.shape[1] - 19]}[kind]


# (B, T, width of the stored rows, D, view)
CASES = {"owsm-d1024": (128, 768, 1024, 1024, "whole"),
         "owsm-gate": (128, 768, 4096, 2048, "second-half"),
         "owsm-valid": (128, 768, 1024, 1024, "first-frames"),
         "ragged": (3, 37, 768, 768, "whole"), "wide": (2, 5, 4096, 4096, "whole")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_its_plain_version(dev, case):
    B, T, width, D, kind = CASES[case]
    g = torch.Generator(device=dev).manual_seed(width + T)
    x = _view((3.0 * torch.randn((B, T, width), generator=g, device=dev) + 0.5)
              .to(torch.bfloat16), kind)
    scale, bias = _params(g, D, dev)
    before = ln_ops.LAUNCHES
    got = ln_ops.layer_norm(x, scale, bias, 1e-12)
    want = ln_ops.layer_norm_reference(x, scale, bias, 1e-12)
    torch.cuda.synchronize()
    assert ln_ops.LAUNCHES == before + 1 and got.is_contiguous() and got.shape == x.shape
    got, want = got.float(), want.float()
    # Both in fp32 (sums in other orders, ~1e-6 of the ~1 normalised
    # values) and rounded once to bf16: at most one step of bf16, 2^-7 of
    # the value, apart.
    apart = (got - want).abs() > 2.0 ** -7 * want.abs() + 1e-5
    assert not apart.any(), f"{int(apart.sum())} values apart"


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((2, 4, 1000), generator=g, device=dev).to(torch.bfloat16)
    scale, bias = _params(g, 1000, dev)
    with pytest.raises(ValueError, match="256"):
        ln_ops.layer_norm(x, scale, bias)
    x = torch.randn((2, 4, 512), generator=g, device=dev).to(torch.bfloat16)
    scale, bias = _params(g, 512, dev)
    with pytest.raises(ValueError, match="fp32"):
        ln_ops.layer_norm(x, scale.to(torch.bfloat16), bias)
    with pytest.raises(ValueError, match="contiguous channels"):
        ln_ops.layer_norm(x.transpose(1, 2).contiguous().transpose(1, 2)[..., :512], scale, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("D", [768, 1024, 1280])
@pytest.mark.parametrize("B", [8, 128])
def test_add_kernel_matches_its_plain_version(dev, B, D, with_bias):
    """K14 at decode shapes ([B, 1, D] rows): x_new bit-equal to the plain
    version's, h within K13's tolerance of it."""
    g = torch.Generator(device=dev).manual_seed(B + D + with_bias)
    x = (3.0 * torch.randn((B, 1, D), generator=g, device=dev) + 0.5).to(torch.bfloat16)
    y = torch.randn((B, 1, D), generator=g, device=dev).to(torch.bfloat16)
    b = (torch.randn((D,), generator=g, device=dev).to(torch.bfloat16)
         if with_bias else None)
    scale, bias = _params(g, D, dev)
    before = ln_ops.ADD_LAUNCHES
    x_new, h = ln_ops.add_layer_norm(x, y, b, scale, bias, 1e-5)
    x_want, h_want = ln_ops.add_layer_norm_reference(x, y, b, scale, bias, 1e-5)
    torch.cuda.synchronize()
    assert ln_ops.ADD_LAUNCHES == before + 1
    assert x_new.shape == h.shape == x.shape and torch.equal(x_new, x_want)
    got, want = h.float(), h_want.float()
    apart = (got - want).abs() > 2.0 ** -7 * want.abs() + 1e-5
    assert not apart.any(), f"{int(apart.sum())} values apart"


@pytest.mark.cuda
def test_add_wrapper_refuses_what_the_kernel_does_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((2, 1, 512), generator=g, device=dev).to(torch.bfloat16)
    scale, bias = _params(g, 512, dev)
    with pytest.raises(ValueError, match="256"):
        ln_ops.add_layer_norm(x[..., :500], x[..., :500], None, scale[:500], bias[:500])
    with pytest.raises(ValueError, match="y must be"):
        ln_ops.add_layer_norm(x, x.float(), None, scale, bias)
    with pytest.raises(ValueError, match="not x's"):
        ln_ops.add_layer_norm(x, x[:1], None, scale, bias)
    x2 = torch.randn((2, 2, 512), generator=g, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        ln_ops.add_layer_norm(x2, x2.transpose(0, 1), None, scale, bias)
    with pytest.raises(ValueError, match="scale must be"):
        ln_ops.add_layer_norm(x, x, None, scale.to(torch.bfloat16), bias)
    with pytest.raises(ValueError, match=r"\[512\]"):
        ln_ops.add_layer_norm(x, x, x[0, 0, :256], scale, bias)
