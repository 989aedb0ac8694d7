"""Port log-mel frontend against sar_tpu.ops.mel on the same seeded clips
(fp32 on the CPU; the two sum the DFT GEMM in another order, so 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import t

from sar_tpu.ops import mel as jmel
from sar_tpu_torch.ops import mel as tmel


@pytest.mark.parametrize("seed,seconds", [(0, 30.0), (1, 7.3)])
def test_log_mel_matches_sar_tpu(seed, seconds):
    rng = np.random.default_rng(seed)
    clip = rng.standard_normal(int(seconds * tmel.SAMPLE_RATE)).astype(np.float32)
    clip *= np.linspace(0.01, 0.5, clip.size, dtype=np.float32)   # dynamic range
    audio = tmel.stack_pad_audio([clip])
    np.testing.assert_array_equal(audio, jmel.stack_pad_audio([clip]))
    want = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio), 80))
    got = tmel.log_mel_spectrogram(t(audio), 80)
    assert got.shape == (1, 80, tmel.N_FRAMES) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_filter_bank_and_basis_are_the_reference_tables():
    np.testing.assert_array_equal(tmel.mel_filter_bank(80), jmel.mel_filter_bank(80))
    np.testing.assert_array_equal(tmel.mel_filter_bank(128), jmel.mel_filter_bank(128))
    np.testing.assert_array_equal(tmel._dft_kernels(), jmel._dft_kernels())


def test_pad_or_trim_and_batch_dim():
    x = torch.arange(10, dtype=torch.float32)
    assert tmel.pad_or_trim(x, 4).tolist() == [0, 1, 2, 3]
    assert tmel.pad_or_trim(x, 12).tolist() == list(range(10)) + [0, 0]
    a = np.random.default_rng(2).standard_normal(tmel.N_SAMPLES).astype(np.float32)
    one = tmel.log_mel_spectrogram(t(a))
    two = tmel.log_mel_spectrogram(t(np.stack([a, a])), dtype=torch.bfloat16)
    assert one.shape == (1, 80, tmel.N_FRAMES)
    assert two.dtype == torch.bfloat16 and two.shape == (2, 80, tmel.N_FRAMES)
