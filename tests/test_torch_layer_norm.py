"""K13, the LayerNorm of bf16 rows with fp32 parameters
(sar_tpu_torch/ops/layer_norm.py, csrc/layer_norm.cu), whose plain version
is `layer_norm_reference` there (`models/whisper.py::layer_norm` too).

CPU case: the wrapper on CPU tensors is the plain version, bit for bit,
and moves no launch counter.

`cuda`-marked cases (skipped without a card): the kernel against its plain
version in bf16 at OWSM v4 medium's shapes (B=128, T 768, D 1024; the
cgMLP gate's D 2048 read as the second half of a [.., 4096] activation;
the first 749 frames of a padded batch, read in place) and ragged ones;
the wrapper refusing what the kernel does not take. This file imports no
JAX, so the card runs it with
`python -m pytest tests/test_torch_layer_norm.py -m cuda -q --noconftest`.
"""

import pytest
import torch

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
