"""K6's plain version (sar_tpu_torch/ops/flash.py) against the JAX package's
flash_mha run in Pallas interpret mode, at tests/test_flash.py's cases:
the output and the three gradients, fp32 on the CPU, within 2e-5 (the two
sum in another order and pad differently: JAX pads to 128 rows and masks
the pads with segment ids, the port masks ragged tiles). Also the plain
versions of the three kernels against autograd of the reference, the
custom-op path on CPU tensors, and the CPU dispatch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import bf16_rounding_case, t
from jax.experimental.pallas import tpu as pltpu

from sar_tpu.ops.flash import flash_mha as jax_flash_mha
from sar_tpu_torch.ops import flash

CASES = [(128, 128, False), (100, 100, True), (100, 300, False)]
TOL = 2e-5


def _inputs(seed, B, H, Tq, Tk, hd=32):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, Tq, hd)) * hd ** -0.5).astype(np.float32)
    k = rng.standard_normal((B, H, Tk, hd)).astype(np.float32)
    v = rng.standard_normal((B, H, Tk, hd)).astype(np.float32)
    w = rng.standard_normal((B, H, Tq, hd)).astype(np.float32)
    return q, k, v, w


@pytest.mark.parametrize("Tq,Tk,causal", CASES)
def test_reference_matches_jax_flash_forward_and_gradients(Tq, Tk, causal):
    q, k, v, w = _inputs(0, 2, 3, Tq, Tk)

    def loss(q, k, v):
        return jnp.sum(jax_flash_mha(q, k, v, causal=causal) * w)
    with pltpu.force_tpu_interpret_mode():
        o_j = jax_flash_mha(*map(jnp.asarray, (q, k, v)), causal=causal)
        g_j = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [t(a).requires_grad_(True) for a in (q, k, v)]
    o_t = flash.flash_mha_reference(*xs, causal=causal)
    g_t = torch.autograd.grad((o_t * t(w)).sum(), xs)
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), atol=TOL, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=0,
                                   err_msg=name)


def test_plain_versions_round_probabilities_to_bf16_as_the_jax_kernel():
    """The bf16 case of _torch_port.bf16_rounding_case (two keys
    scoring 0 and -2^-10, values +1 and -1: bf16 rounds both probabilities
    alike) through JAX's flash_mha in interpret mode, in bf16, and through
    K6's plain versions: every output entry is exactly 0."""
    q, k, v = (x[:, :2, None].swapaxes(1, 2) for x in bf16_rounding_case())   # [1, 1, 2, 64]
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash_mha(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    assert not np.asarray(want.astype(jnp.float32)).any()
    qt, kt, vt = (t(x).to(torch.bfloat16) for x in (q, k, v))
    o, _ = flash.flash_attention_fwd_reference(qt, kt, vt)
    assert not o.float().any()
    assert not flash.flash_mha_reference(qt, kt, vt).float().any()


@pytest.mark.parametrize("Tq,Tk,causal", CASES)
def test_kernel_plain_versions_match_autograd(Tq, Tk, causal):
    """The plain versions of the forward (o, lse), dK/dV and dQ kernels
    against autograd of flash_mha_reference, fp32, within 1e-5."""
    q, k, v, w = map(t, _inputs(1, 2, 3, Tq, Tk))
    xs = [a.clone().requires_grad_(True) for a in (q, k, v)]
    o = flash.flash_mha_reference(*xs, causal=causal)
    want = torch.autograd.grad(o, xs, w)
    o2, lse = flash.flash_attention_fwd_reference(q, k, v, causal=causal)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    torch.testing.assert_close(o2, o.detach(), atol=1e-5, rtol=0)
    di = (o2 * w).sum(-1)
    dk, dv = flash.flash_attention_bwd_dkv(q, k, v, w, lse, di, causal=causal)
    dq = flash.flash_attention_bwd_dq(q, k, v, w, lse, di, causal=causal)
    for name, got, exp in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        torch.testing.assert_close(got, exp, atol=1e-5, rtol=0, msg=name)


def test_custom_op_path_on_cpu_tensors():
    """The custom op with its registered autograd, on CPU tensors (each
    kernel wrapper takes its plain version), in q/o's [B, T, H, hd] layout
    as the model hands them over: the same output and gradients as the
    reference, no kernel launched."""
    q, k, v, w = map(t, _inputs(2, 2, 3, 100, 100))
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)     # [B, T, H, hd] storage
    n = (flash.LAUNCHES, flash.DKV_LAUNCHES, flash.DQ_LAUNCHES)
    for causal in (False, True):
        xs = [a.clone().requires_grad_(True) for a in (qs, k, v)]
        o = flash.flash_mha_op(*xs, causal)
        assert o.shape == q.shape and o.transpose(1, 2).is_contiguous()
        got = torch.autograd.grad(o, xs, w)
        ys = [a.clone().requires_grad_(True) for a in (q, k, v)]
        o_r = flash.flash_mha_reference(*ys, causal=causal)
        want = torch.autograd.grad(o_r, ys, w)
        torch.testing.assert_close(o.detach(), o_r.detach(), atol=1e-5, rtol=0)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    assert (flash.LAUNCHES, flash.DKV_LAUNCHES, flash.DQ_LAUNCHES) == n


def test_cpu_dispatch_takes_the_plain_version(monkeypatch):
    """flash_mha on CPU tensors is flash_mha_reference, and never reaches a
    kernel wrapper; the wrappers' argument checks refuse CUDA-only cases
    before any build or launch."""
    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was called for CPU tensors")
    monkeypatch.setattr(flash, "flash_attention_fwd", boom)
    q, k, v, _ = map(t, _inputs(3, 1, 2, 40, 40))
    out = flash.flash_mha(q, k, v, causal=True)
    torch.testing.assert_close(out, flash.flash_mha_reference(q, k, v, causal=True))
    x = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16)
    y = torch.zeros((1, 2, 96, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel for devices"):
        flash._require_kernel_args("flash_attention_fwd", False, q=x, k=y, v=y)
