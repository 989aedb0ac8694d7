"""chip_smoke.py, the port's on-card smoke run, must refuse to run without
a CUDA device — exiting non-zero with the reason and no result line —
instead of falling back to the CPU; and the build helper must say so
clearly when there is no nvcc."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is false" in out.stderr
    assert '"ok"' not in out.stdout


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from torch.utils import cpp_extension

    from sar_tpu_torch.ops import _build
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_key_covers_every_source():
    from sar_tpu_torch.ops import _build
    names = {p.name for p in _build.sources()}
    assert {"flash_enc.cu", "kv_init.cu", "decode_cross.cu", "decode_cross_s8.cu",
            "flash_attn.cu", "decode_self.cu", "decode_attention.cu",
            "common.cuh", "mma.cuh"} <= names
    assert _build.source_hash() == _build.source_hash()
    assert set(_build.SIGNATURES) == {"sar_encoder_attention_hm",
                                      "sar_encoder_attention_fused",
                                      "sar_encoder_ln_qkv",
                                      "sar_fused_kv_init", "sar_fused_kv_init_lora",
                                      "sar_cross_decode_exact",
                                      "sar_cross_decode_exact_beam",
                                      "sar_cross_decode_s8",
                                      "sar_flash_attn_fwd", "sar_flash_attn_bwd_dkv",
                                      "sar_flash_attn_bwd_dq", "sar_self_decode_s8",
                                      "sar_decode_attention"}
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in "".join(
            p.read_text() for p in _build.sources())
