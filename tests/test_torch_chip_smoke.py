"""chip_smoke.py, the port's on-card smoke run, must refuse to run without
a CUDA device — exiting non-zero with the reason and no result line —
instead of falling back to the CPU; and the build helper must say so
clearly when there is no nvcc."""

import subprocess
import sys
from pathlib import Path

import numpy as np
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
    assert {"flash_enc.cu", "kv_init.cu", "decode_cross.cu", "decode_s8.cu",
            "flash_attn.cu", "decode_attention.cu", "decode_self_exact.cu",
            "dwconv_time.cu", "layer_norm.cu", "common.cuh", "mma.cuh",
            "cluster.cuh"} <= names
    assert _build.source_hash() == _build.source_hash()
    assert set(_build.SIGNATURES) == {"sar_encoder_attention_hm",
                                      "sar_encoder_attention_fused",
                                      "sar_encoder_ln_qkv",
                                      "sar_fused_kv_init", "sar_fused_kv_init_lora",
                                      "sar_cross_decode_exact",
                                      "sar_cross_decode_exact_beam",
                                      "sar_cross_decode_exact_form",
                                      "sar_cross_decode_form",
                                      "sar_cross_decode_s8", "sar_s8_cluster_size",
                                      "sar_flash_attn_fwd", "sar_flash_attn_bwd_dkv",
                                      "sar_flash_attn_bwd_dq", "sar_self_decode_s8",
                                      "sar_decode_attention", "sar_s8_decode_probe",
                                      "sar_self_decode_exact", "sar_dwconv_time",
                                      "sar_layer_norm_rows", "sar_add_layer_norm_rows"}
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in "".join(
            p.read_text() for p in _build.sources())


@pytest.mark.parametrize("lora", [False, True])
def test_kv_library_yardstick_computes_the_kernels_function(lora):
    """chip_smoke's K2/K4 library composite (per-layer GEMMs, then
    quantize_rows) is the plain version's function: on the CPU in fp32 the
    int8 values agree up to |d| <= 1 on a few entries (another summation
    order) and the scales within 1e-5."""
    import chip_smoke
    from sar_tpu_torch.ops import kv_init
    rng = np.random.default_rng(5)
    L, B, S_pad, D, H, t_valid, r = 2, 2, 128, 128, 2, 100, 8
    x = torch.from_numpy(rng.standard_normal((B, S_pad, D)).astype(np.float32))
    x[:, t_valid:] = 0
    wk, wv = (torch.from_numpy(rng.standard_normal((L, D, D)).astype(np.float32) * 0.05)
              for _ in range(2))
    bv = torch.from_numpy(rng.standard_normal((L, D)).astype(np.float32) * 0.05)
    kw = {}
    if lora:
        kw = dict(va=torch.from_numpy(rng.standard_normal((L, 1, D, r)).astype(np.float32) * 0.1),
                  vb=torch.from_numpy(rng.standard_normal((L, 1, r, D)).astype(np.float32) * 0.1),
                  lora_scale=2.0)
    lib = chip_smoke._kv_library(x, wk, wv, bv, H, t_valid, **kw)
    want = kv_init.fused_kv_init_reference(x, wk, wv, bv, n_heads=H, t_valid=t_valid, **kw)
    for l, ((kq, ks), (vq, vs)) in enumerate(lib):
        for got_q, got_s, i in ((kq, ks, 0), (vq, vs, 2)):
            d = (got_q.int() - want[i][l].int()).abs()
            assert d.max().item() <= 1 and (d != 0).float().mean().item() <= 1e-3
            np.testing.assert_allclose(got_s.numpy(), want[i + 1][l].numpy(), rtol=1e-5, atol=0)


def test_decode_steps_reports_the_steps_run():
    """chip_smoke's reading of a greedy batch: the steps needed (up to the
    one after which every row has emitted EOS), the steps run (to the end
    of that step's segment) and the segments, one host sync each."""
    import chip_smoke
    from sar_tpu_torch.models.config import get_config
    cfg = get_config("whisper-test")
    P, total = 4, 64
    tokens = torch.full((2, total), 7)
    tokens[0, P + 3] = cfg.eos_token_id
    tokens[1, P + 40] = cfg.eos_token_id
    assert chip_smoke.decode_steps(tokens, cfg, P) == (44, 63)
    assert chip_smoke.decode_steps(tokens, cfg, P, segment=8) == (44, 48)
    assert chip_smoke.decode_steps(tokens, cfg, P, segment=0) == (44, 63)
    tokens[1, P + 40] = 7                       # a row that never ends
    assert chip_smoke.decode_steps(tokens, cfg, P) == (63, 63)
    assert chip_smoke.segments_run(total, 63) == 2
    assert chip_smoke.segments_run(total, 48, segment=8) == 6


def test_phase_list_ends_with_the_phase2_clis_and_imports_no_jax():
    """chip_smoke.py drives the LID sweep and routed inference CLIs after
    the lid phase (whose head the route phase reads), then single-file
    transcription, streaming and the HTTP server (whose routed server reads
    the route phase's adapters), then the device-mesh phase, the
    mixed-precision caches and OWSM, and neither
    importing it nor building its phase list pulls in jax or sar_tpu."""
    code = ("import sys, chip_smoke\n"
            "names = [n for n, _ in chip_smoke.path_phases(None, None, 0, None, 'w')]\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'sar_tpu')]\n"
            "print(names, bad, sep='\\n')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    names, bad = out.stdout.strip().splitlines()
    assert names == str(["greedy", "routed", "beam", "train", "s8", "fq", "bench", "graphs",
                         "lid", "sweep", "route", "transcribe", "stream", "serve",
                         "mesh", "mixed", "owsm"])
    assert bad == "[]"


def test_fallback_passes_count_the_ladder():
    """The transcribe phase's design count of K2 (K4) launches: one pass
    per temperature up to the highest a row reached, best_of at T > 0."""
    import chip_smoke
    temps = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    rows = [{"temperature": 0.0}, {"temperature": 0.4}, {"temperature": 0.2}]
    assert chip_smoke.fallback_passes(rows, temps, 2) == 1 + 2 + 2
    assert chip_smoke.fallback_passes(rows[:1], temps, 5) == 1
    assert chip_smoke.fallback_passes([{"temperature": 1.0}], temps, 2) == 11


def test_output_format_check_parses_every_writer(tmp_path, monkeypatch):
    """The transcribe phase's check of the written files passes on the
    writers' own output, with cue texts that hold line breaks, and fails a
    file that lost a cue."""
    import chip_smoke
    from sar_tpu_torch.evaluation import writers
    segments = [(0.0, 1.5, "one\ntwo"), (None, 3.25, "a\rb\tc"), (3.25, None, "x"),
                (3700.0, 3701.0, "late")]
    words = [{"word": "one", "start": 0.0, "end": 0.4, "probability": 0.5}]
    sizes = chip_smoke.check_output_formats(tmp_path, "clip", "one two x", segments, words)
    assert set(sizes) == set(writers.WRITERS) and all(sizes.values())
    assert chip_smoke.check_output_formats(tmp_path, "empty", "", [], [])["srt"] == 0
    real = writers.render
    monkeypatch.setattr(writers, "render", lambda fmt, text, segments=None, words=None:
                        real(fmt, text, segments=(segments or [])[:-1], words=words))
    with pytest.raises(RuntimeError, match="does not parse"):
        chip_smoke.check_output_formats(tmp_path, "lost", "t", segments, words)


def test_recording_transcribers_records_and_restores(monkeypatch):
    import chip_smoke
    from sar_tpu_torch.evaluation import fallback
    cls = fallback.FallbackTranscriber
    monkeypatch.setattr(cls, "__init__", lambda self, *a, **k: None)
    monkeypatch.setattr(cls, "__call__", lambda self, *a, **k: (["t", None],
                                                                [{"temperature": 0.0}, None]))
    with chip_smoke.recording_transcribers() as made:
        tr = fallback.FallbackTranscriber()
        tr("mel")
    assert fallback.FallbackTranscriber is cls and made == [tr]
    assert tr.infos == [[{"temperature": 0.0}]]


def test_stream_updates_count_the_decoded_windows():
    """The stream phase's design count of K1 (K2) launches: one window per
    feed plus one per rollover."""
    import chip_smoke
    assert chip_smoke.stream_updates(40 * 16000, 2 * 16000, 30 * 16000) == 21
    assert chip_smoke.stream_updates(30 * 16000, 2 * 16000, 30 * 16000) == 15
    assert chip_smoke.stream_updates(10, 4, 3) == 3 + 3        # each feed passes the window once
    assert chip_smoke.stream_updates(61, 61, 30) == 3


def test_the_stream_phase_holds_its_batch_of_one_against_the_plain_versions(monkeypatch):
    """The stream phase records the first update's K1/K2/K3 inputs (batch 1)
    and runs each call again through the wrapper and its plain version. On
    the CPU the wrapper is the plain version (errors 0); a wrapper that is
    off by 10 % fails the check."""
    import chip_smoke
    from sar_tpu_torch.data import CharTokenizer
    from sar_tpu_torch.evaluation.streaming import StreamingTranscriber
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.models.config import get_config
    from sar_tpu_torch.ops import decode_cross
    cfg = get_config("whisper-test")
    params = whisper.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    st = StreamingTranscriber(cfg, params, CharTokenizer(cfg), language="english",
                              max_new_tokens=4, kv_int8=True, flash="hm", device="cpu")
    audio = (np.random.default_rng(0).standard_normal(st.window_samples // 2) * 0.1
             ).astype(np.float32)
    n = max(cfg.encoder_layers, cfg.decoder_layers)
    with chip_smoke.recording_kernel_inputs(n) as calls:
        st.feed(audio)
    assert all(getattr(whisper, k) is not None and getattr(whisper, k).__name__ == k
               for k in chip_smoke.STREAM_KERNELS)
    assert [len(calls[k]) for k in chip_smoke.STREAM_KERNELS] == [
        cfg.encoder_layers, 1, n]
    errors = chip_smoke.check_recorded_kernels("stream", calls)
    assert {e["batch"] for e in errors.values()} == {1}
    assert all(e["max_abs_err"] == 0.0 for e in errors.values())
    plain = decode_cross.cross_decode_attention_exact
    monkeypatch.setattr(decode_cross, "cross_decode_attention_exact",
                        lambda *a, **k: plain(*a, **k) * 1.1)
    with pytest.raises(RuntimeError, match="cross_decode_attention_exact at batch 1"):
        chip_smoke.check_recorded_kernels("stream", calls)
