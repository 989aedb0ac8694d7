"""K8's plain version (sar_tpu_torch/ops/flash_enc.py) against the JAX
package's fused LN + QKV + attention kernel run in Pallas interpret mode,
at tests/test_flash_enc.py's world (B=2, H=4, hd=16, T_pad=128,
t_valid=50): fp32 within 2e-5 (the two sum in another order), bf16 within
2e-2 (bf16 params and activations, fp32 LN params: a bf16 rounding of q,
k, v or p that lands on the other side of a tie moves an output by one
bf16 ulp of ~1). Also: garbage in the padded rows leaves the valid rows
as they are, the route rule `fused_qkv_supported` equals JAX's over a grid
of shapes, CPU tensors take the plain version without moving the launch
counter, and a tensor on a device with no kernel raises. The rules of the
tensor-core projection half: its column tile never straddles two of the
q/k/v planes, its resident h fits a block's shared memory at the widths
the route sends to it, and the wrapper names the limit where it does not;
its plain version is K8's own first half."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import t

from sar_tpu.ops import flash_enc as jfe
from sar_tpu_torch.ops import flash_enc

B, H, HD, T_PAD, T_VALID = 2, 4, 16, 128, 50
D = H * HD
NAMES = ("ln_scale", "ln_bias", "wq", "bq", "wk", "wv", "bv")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, T_PAD, D)).astype(np.float32)
    x[:, T_VALID:] = 0.0
    p = {
        "ln_scale": rng.standard_normal(D).astype(np.float32) * 0.1 + 1.0,
        "ln_bias": rng.standard_normal(D).astype(np.float32) * 0.1,
        "wq": rng.standard_normal((D, D)).astype(np.float32) * 0.1,
        "bq": rng.standard_normal(D).astype(np.float32) * 0.1,
        "wk": rng.standard_normal((D, D)).astype(np.float32) * 0.1,
        "wv": rng.standard_normal((D, D)).astype(np.float32) * 0.1,
        "bv": rng.standard_normal(D).astype(np.float32) * 0.1,
    }
    return x, p


def _jax(x, p, dtype=jnp.float32):
    args = [jnp.asarray(p[n]) if n.startswith("ln") else jnp.asarray(p[n], dtype)
            for n in NAMES]
    out = jfe.encoder_attention_fused(jnp.asarray(x, dtype), *args, n_heads=H,
                                      t_valid=T_VALID, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(x, p, dtype=torch.float32, fn=flash_enc.encoder_attention_fused):
    args = [t(p[n]) if n.startswith("ln") else t(p[n]).to(dtype) for n in NAMES]
    return fn(t(x).to(dtype), *args, n_heads=H, t_valid=T_VALID)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_plain_version_matches_the_jax_kernel(world, dtype, tol):
    x, p = world
    got = _port(x, p, getattr(torch, dtype))
    want = _jax(x, p, getattr(jnp, dtype))
    assert got.shape == (B, T_PAD, D) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got[:, :T_VALID].float().numpy(), want[:, :T_VALID],
                               atol=tol, rtol=tol)


def test_plain_version_matches_the_unfused_layer_math(world):
    """LN (two-pass variance) + projections + K1's plain attention: the
    one-pass variance and the single rounding of q change nothing at fp32
    beyond 2e-5."""
    from sar_tpu_torch.models import whisper
    x, p = world
    tp = {n: t(p[n]) for n in NAMES}
    h = whisper.layer_norm(t(x), tp["ln_scale"], tp["ln_bias"])
    q = (h @ tp["wq"] + tp["bq"]) * HD ** -0.5
    want = flash_enc.encoder_attention_hm_reference(
        q, h @ tp["wk"], h @ tp["wv"] + tp["bv"], n_heads=H, t_valid=T_VALID)
    got = _port(x, p)
    np.testing.assert_allclose(got[:, :T_VALID].numpy(), want[:, :T_VALID].numpy(),
                               atol=2e-5, rtol=2e-5)


def test_padded_rows_do_not_reach_the_valid_rows(world):
    x, p = world
    x2 = x.copy()
    x2[:, T_VALID:] = 37.0
    a, b = _port(x, p), _port(x2, p)
    assert torch.equal(a[:, :T_VALID], b[:, :T_VALID])
    assert torch.isfinite(a).all()                 # zero pad rows: h = LN bias


@pytest.mark.parametrize("T", [128, 256, 1000, 1024, 1536, 3072])
@pytest.mark.parametrize("D_,H_", [(64, 4), (384, 6), (768, 12), (1024, 16),
                                    (1280, 20), (96, 3), (192, 2)])
def test_route_rule_equals_jax(T, D_, H_):
    assert flash_enc.fused_qkv_supported(T, D_, H_) == jfe.fused_qkv_supported(T, D_, H_)


def test_route_rule_on_the_jax_tests_shapes():
    assert flash_enc.fused_qkv_supported(1536, 768, 12)        # whisper-small
    assert flash_enc.fused_qkv_supported(1536, 1024, 16)       # whisper-medium
    assert not flash_enc.fused_qkv_supported(1536, 1280, 20)   # whisper-large
    assert not flash_enc.fused_qkv_supported(1000, 768, 12)    # unaligned T


def test_cpu_tensors_take_the_plain_version_and_other_devices_raise(world):
    x, p = world
    n = flash_enc.FUSED_LAUNCHES
    got = _port(x, p)
    assert flash_enc.FUSED_LAUNCHES == n
    assert torch.equal(got, _port(x, p, fn=flash_enc.encoder_attention_fused_reference))
    meta = [torch.empty(s, device="meta") for s in ((B, T_PAD, D), (D,), (D,), (D, D), (D,),
                                                   (D, D), (D, D), (D,))]
    with pytest.raises(ValueError, match="no kernel"):
        flash_enc.encoder_attention_fused(*meta, n_heads=H, t_valid=T_VALID)
    assert flash_enc.FUSED_LAUNCHES == n


@pytest.mark.parametrize("T", [64, 192, 1536])
@pytest.mark.parametrize("H_", range(1, 33))
def test_projection_config_divides_every_plane(T, H_):
    """Where a configuration fits, its rows divide T_pad, its column tile
    divides D (no tile straddles two of the q/k/v planes) and its shared
    memory fits a block; every width up to 1472 has one."""
    D_ = 64 * H_
    c = flash_enc.ln_qkv_config(T, D_)
    if D_ <= 1472:
        assert c is not None
    if c is not None:
        assert T % c[0] == 0 and D_ % c[1] == 0
        assert flash_enc.ln_qkv_shared_bytes(c, D_) <= 232_448


@pytest.mark.parametrize("D_,H_", [(768, 12), (1024, 16)])
def test_resident_h_fits_at_the_fused_widths(D_, H_):
    """whisper-small and -medium, the widths the route rule sends to K8:
    96-row tiles at whisper's T_pad of 1536 (a 4-stage W ring at D=768, 2
    at D=1024), 64 rows when T_pad is not a multiple of 96."""
    assert flash_enc.fused_qkv_supported(1536, D_, H_)
    rows, cols, k_rows, stages = flash_enc.ln_qkv_config(1536, D_)
    assert (rows, cols, stages) == (96, 256, 4 if D_ == 768 else 2)
    want = 2 * (rows * (D_ + 8) + stages * k_rows * (cols + 8))
    assert flash_enc.ln_qkv_shared_bytes((rows, cols, k_rows, stages), D_) == want <= 232_448
    assert flash_enc.ln_qkv_config(64, D_)[0] == 64
    flash_enc.check_ln_qkv_width("K8", 1536, D_)          # does not raise


@pytest.mark.parametrize("D_", [1728, 2048, 2560])
def test_widths_that_do_not_fit_are_refused_with_the_limit(D_):
    assert flash_enc.ln_qkv_config(1536, D_) is None
    with pytest.raises(ValueError, match=f"D={D_} needs at least .* more than the 232448"):
        flash_enc.check_ln_qkv_width("K8", 1536, D_)


def test_projection_half_plain_version_is_the_fused_first_half(world):
    """encoder_ln_qkv (CPU: its plain version) gives the q/k/v that the
    fused plain version attends over, without moving a launch counter."""
    x, p = world
    n = flash_enc.LN_QKV_LAUNCHES
    qkv = _port(x, p, torch.bfloat16, fn=lambda *a, n_heads, t_valid:
                flash_enc.encoder_ln_qkv(*a, n_heads=n_heads))
    assert flash_enc.LN_QKV_LAUNCHES == n
    assert qkv.shape == (3, B, T_PAD, D) and qkv.dtype == torch.bfloat16
    want = _port(x, p, torch.bfloat16)
    got = flash_enc.encoder_attention_hm_reference(*qkv, n_heads=H, t_valid=T_VALID)
    assert torch.equal(got, want)
