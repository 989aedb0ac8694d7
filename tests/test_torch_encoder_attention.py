"""Port K1 plain version (encoder_attention_hm_reference) against the JAX
head-minor kernel in interpret mode and against whisper.attention, fp32 on
the CPU within 2e-5 on valid rows; CPU dispatch takes the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import t

from sar_tpu.models import whisper as jw
from sar_tpu.ops.flash_enc import encoder_attention_hm as jax_hm
from sar_tpu_torch.ops import flash_enc

B, H, hd, T_VALID, T_PAD = 2, 4, 16, 50, 64
D = H * hd


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(5)

    def mk():
        x = rng.standard_normal((B, T_PAD, D)).astype(np.float32)
        x[:, T_VALID:] = rng.standard_normal((B, T_PAD - T_VALID, D)) * 3.0   # garbage
        return x
    return mk(), mk(), mk()


def _port(q, k, v):
    return flash_enc.encoder_attention_hm_reference(
        t(q), t(k), t(v), n_heads=H, t_valid=T_VALID).numpy()


def test_reference_matches_jax_kernel_interpret(qkv):
    q, k, v = qkv
    want = np.asarray(jax_hm(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             n_heads=H, t_valid=T_VALID, interpret=True))
    np.testing.assert_allclose(_port(q, k, v)[:, :T_VALID], want[:, :T_VALID],
                               rtol=2e-5, atol=2e-5)


def test_reference_matches_exact_attention(qkv):
    q, k, v = (jnp.asarray(x) for x in qkv)
    mask = (jnp.arange(T_PAD) < T_VALID)[None, None, None]
    want = jw.merge_heads(jw.attention(jw.split_heads(q, H), jw.split_heads(k, H),
                                       jw.split_heads(v, H), mask))
    np.testing.assert_allclose(_port(*qkv)[:, :T_VALID],
                               np.asarray(want)[:, :T_VALID], rtol=2e-5, atol=2e-5)


def test_padded_query_rows_do_not_contaminate(qkv):
    q, k, v = qkv
    q2 = q.copy()
    q2[:, T_VALID:] = 1e3
    np.testing.assert_array_equal(_port(q, k, v)[:, :T_VALID],
                                  _port(q2, k, v)[:, :T_VALID])


def test_cpu_dispatch_takes_the_plain_version(qkv):
    q, k, v = (t(x) for x in qkv)
    before = flash_enc.LAUNCHES
    got = flash_enc.encoder_attention_hm(q, k, v, n_heads=H, t_valid=T_VALID)
    assert torch.equal(got, flash_enc.encoder_attention_hm_reference(
        q, k, v, n_heads=H, t_valid=T_VALID))
    assert flash_enc.LAUNCHES == before           # counts kernel launches only


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty((1, 64, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_enc.encoder_attention_hm(q, q, q, n_heads=1, t_valid=64)
