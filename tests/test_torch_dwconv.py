"""K12, the depthwise time convolution of the E-Branchformer blocks
(sar_tpu_torch/ops/dwconv.py, csrc/dwconv_time.cu).

CPU cases: the plain version against the convolution written out tap by
tap (the zero padding of the valid frames, the bias, the gate, the
residual), at OWSM's 31 taps and owsm-test's 7; the wrapper on CPU tensors
is the plain version and moves no launch counter.

`cuda`-marked cases (skipped without a card): the kernel against its plain
version in bf16 at OWSM v4 medium's B=128 shapes (T 768 with 749 valid,
C 2048, 31 taps; gated and residual) and at ragged small ones (C not a
multiple of 256, T not a multiple of 32); pad rows holding NaN never read;
the wrapper refusing what the kernel does not take. This file imports no
JAX, so the card runs it with
`python -m pytest tests/test_torch_dwconv.py -m cuda -q --noconftest`.
"""

import pytest
import torch

from sar_tpu_torch.ops import dwconv


def _written_out(x, w, b, t_valid, gate, residual):
    """fp64, tap by tap: y[t] = b + sum_j w[:, j] * x[t + j - K // 2]."""
    B, T, C = x.shape
    K = w.shape[-1]
    xs = x.double().clone()
    xs[:, t_valid:] = 0.0
    y = b.double().expand(B, T, C).clone()
    for j in range(K):
        s = j - K // 2
        lo, hi = max(0, -s), min(T, T - s)
        y[:, lo:hi] += w[:, j].double() * xs[:, lo + s:hi + s]
    if gate is not None:
        y = y * gate.double()
    if residual:
        y = y + x.double()
    return y


def _operands(g, B, T, C, K, device="cpu", dtype=torch.float32, gate_width=None):
    x = torch.randn((B, T, C), generator=g, device=device).to(dtype)
    w = (0.2 * torch.randn((C, 1, K), generator=g, device=device)).to(dtype)
    b = (0.1 * torch.randn((C,), generator=g, device=device)).to(dtype)
    u = torch.randn((B, T, gate_width or C), generator=g, device=device).to(dtype)
    return x, w, b, u[..., :C]


@pytest.mark.parametrize("epilogue", ["none", "gate", "residual"])
@pytest.mark.parametrize("K,t_valid", [(31, 37), (31, 50), (7, 45)])
def test_plain_version_is_the_convolution_written_out(K, t_valid, epilogue):
    g = torch.Generator().manual_seed(K + t_valid)
    x, w, b, r = _operands(g, 2, 50, 6, K, gate_width=12)
    gate = r if epilogue == "gate" else None
    got = dwconv.depthwise_conv_time_reference(
        x, w, b, t_valid=t_valid if t_valid < 50 else None, gate=gate,
        residual=epilogue == "residual")
    want = _written_out(x, w[:, 0], b, t_valid, gate, epilogue == "residual")
    # fp32 sums of 31 products of ~0.2 against fp64: ~1e-6.
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=1e-5)


def test_wrapper_on_cpu_is_the_plain_version():
    g = torch.Generator().manual_seed(3)
    x, w, b, r = _operands(g, 2, 40, 8, 7)
    before = dwconv.LAUNCHES
    got = dwconv.depthwise_conv_time(x, w, b, t_valid=33, gate=r)
    assert torch.equal(got, dwconv.depthwise_conv_time_reference(x, w, b, t_valid=33, gate=r))
    assert dwconv.LAUNCHES == before


# ---------------------------------------------------------------------------
# On the card.

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


# (B, T, t_valid, C, K, gate row width): OWSM v4 medium's cgMLP gate and
# merge at B=128, and ragged small shapes.
SHAPES = {"owsm-b128": (128, 768, 749, 2048, 31, 4096),
          "ragged": (3, 100, 71, 130, 31, 260), "short-k": (2, 64, 64, 64, 7, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["gate", "residual"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_its_plain_version(dev, shape, epilogue):
    B, T, t_valid, C, K, width = SHAPES[shape]
    g = torch.Generator(device=dev).manual_seed(T + C)
    x, w, b, r = _operands(g, B, T, C, K, dev, torch.bfloat16, width)
    x[:, t_valid:] = float("nan")            # pad rows: never read by the sum
    kw = dict(t_valid=t_valid, gate=r if epilogue == "gate" else None,
              residual=epilogue == "residual")
    before = dwconv.LAUNCHES
    got = dwconv.depthwise_conv_time(x, w, b, **kw)
    want = dwconv.depthwise_conv_time_reference(x, w, b, **kw)
    torch.cuda.synchronize()
    assert dwconv.LAUNCHES == before + 1 and got.dtype == torch.bfloat16
    got, want = got[:, :t_valid].float(), want[:, :t_valid].float()
    assert torch.isfinite(got).all()
    # Both sum in fp32 (in other orders: ~31 * 1e-7 of terms of ~1, so
    # 1e-5 absolute) and round once to bf16, which can put the two on
    # either side of a rounding boundary: one step of bf16, at most 2^-7
    # of the value, apart.
    apart = (got - want).abs() > 2.0 ** -7 * want.abs() + 1e-5
    assert not apart.any(), (f"{int(apart.sum())} values apart, the worst by "
                             f"{(got - want).abs().max().item()} at {apart.nonzero()[:4].tolist()}")


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    x, w, b, r = _operands(g, 2, 40, 8, 7, dev, torch.bfloat16, 16)
    with pytest.raises(ValueError, match="odd K"):
        dwconv.depthwise_conv_time(x, w[..., :6].contiguous(), b)
    with pytest.raises(ValueError, match="gate"):
        dwconv.depthwise_conv_time(x, w, b, gate=r.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="bfloat16"):
        dwconv.depthwise_conv_time(x.float(), w, b)
