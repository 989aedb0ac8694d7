"""The port's transcribe CLI (sar_tpu_torch/scripts/transcribe.py) against
the JAX package's scripts/transcribe.py on the CPU: both given the same
whisper-test weights (the JAX ones bridged over, scaled x5), the same WAV
file and the same flags, each mode's printed text, returned results and
written --output_format json (text, segments and words; word
probabilities to 1e-5) are equal. The modes: the default window, beams
(with a length penalty, with timestamps), timestamps, word timestamps,
the fallback ladder with its gates off (T = 0 accepted, best_of 2),
long-form (plain, overlapped, timestamps + words +
fallback), the conditioned loop (previous text with timestamps, an
initial prompt carried, the hallucination-silence threshold), clip
ranges, --language auto, --task translate, an adapter saved by the JAX
package, and streaming (the file fed in chunks across two rollovers; and
taking precedence over long-form, beams, timestamps and conditioning). Then: each output format's bytes equal JAX's `render` on
crafted segments and words; a sampled pass (--temperature alone: the
port's draws are not JAX's) the same on two runs; --platform refused; `main` end to end with the port's own whisper-test
weights."""

import json
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
from _torch_port import get_config, jax_whisper, random_bank

from sar_tpu.evaluation import writers as jwriters
from sar_tpu.models import lora as jlora
from sar_tpu_torch.data import CharTokenizer
from sar_tpu_torch.evaluation import writers as twriters
from sar_tpu_torch.scripts import transcribe as port_cli

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import transcribe as jax_cli  # noqa: E402

CFG = get_config("whisper-test")
GATES_OFF = ["--logprob_threshold", "-1000", "--compression_ratio_threshold", "1000"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(0)
    files = {}
    for name, sr, seconds in (("short", 16000, 0.5), ("long", 22050, 1.5)):
        path = d / f"{name}.wav"
        samples = (rng.standard_normal(int(seconds * sr)) * 8000).astype(np.int16)
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(samples.tobytes())
        files[name] = str(path)
    jb, _ = random_bank(CFG, 1, 4, seed=3, std=0.3)
    jlora.save_adapter(d / "run" / "adapter", jb, jlora.LoraConfig(r=4, alpha=8))
    return (*jax_whisper(CFG, seed=0, w_scale=5.0), files, d / "run")


MODES = {
    "default": ["short"],
    "beams": ["short", "--num_beams", "2", "--length_penalty", "0.8"],
    "beams_timestamps": ["short", "--num_beams", "2", "--timestamps"],
    "timestamps": ["short", "--timestamps"],
    "words": ["short", "--word_timestamps"],
    "fallback": ["short", "--fallback", "--best_of", "2", *GATES_OFF],
    "longform": ["long", "--longform", "--chunk_seconds", "0.6"],
    "longform_overlap": ["long", "--chunk_seconds", "0.6", "--overlap_seconds", "0.2"],
    "longform_extras": ["long", "--chunk_seconds", "0.6", "--timestamps", "--word_timestamps",
                        "--fallback", *GATES_OFF],
    "conditioned": ["long", "--chunk_seconds", "0.6", "--condition_on_previous_text",
                    "--timestamps"],
    "initial_prompt": ["long", "--chunk_seconds", "0.6", "--initial_prompt", "ab",
                       "--carry_initial_prompt", "--word_timestamps"],
    "hallucination": ["long", "--chunk_seconds", "0.6",
                      "--hallucination_silence_threshold", "0.3"],
    "clips": ["long", "--chunk_seconds", "0.6", "--clip_timestamps", "0.1,0.7,0.9",
              "--word_timestamps"],
    "auto_translate": ["short", "--language", "auto", "--task", "translate"],
    "adapter": ["short", "--checkpoint", "ADAPTER", "--timestamps"],
    "streaming": ["long", "--streaming", "--stream_chunk_seconds", "0.25"],
    "streaming_over_the_rest": ["short", "--streaming", "--stream_chunk_seconds", "0.2",
                                "--longform", "--num_beams", "2", "--timestamps",
                                "--condition_on_previous_text"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_each_mode_equals_the_jax_script(setup, mode, monkeypatch, tmp_path, capsys):
    import sar_tpu.models.base as jbase
    jp, tp, files, adapter = setup
    name, *flags = MODES[mode]
    flags = [str(adapter) if f == "ADAPTER" else f for f in flags]
    argv = [files[name], "--model", "whisper-test", "--language", "english",
            "--max_new_tokens", "6", "--output_format", "json", *flags]
    monkeypatch.setattr(jbase, "load_base_model", lambda *a, **k: (CFG, jp))
    outs = []
    for side, run in (("jax", lambda a: jax_cli.main(a)),
                      ("port", lambda a: _port_run(a, tp))):
        out_dir = tmp_path / side
        results = run(argv + ["--output_dir", str(out_dir)])
        printed = capsys.readouterr().out
        written = json.loads((out_dir / (Path(files[name]).stem + ".json")).read_text())
        outs.append((results, printed, written))
    (got, got_printed, got_json), (want, want_printed, want_json) = outs[1], outs[0]
    assert got == want and got_printed == want_printed
    words, want_words = got_json.pop("words", None), want_json.pop("words", None)
    assert got_json == want_json
    assert (words is None) == (want_words is None)
    if words is not None:
        assert [{**w, "probability": 0} for w in words] == \
            [{**w, "probability": 0} for w in want_words]
        np.testing.assert_allclose([w["probability"] for w in words],
                                   [w["probability"] for w in want_words], atol=1e-5)


def _port_run(argv, tp):
    """The port's CLI past its model loading, on the CPU: the bridged
    weights, the tokenizer and the adapter `main` would load."""
    from sar_tpu_torch.models import lora as lora_lib
    args = port_cli.parse_args(argv + ["--device", "cpu"])
    lora, scale = None, 1.0
    if args.checkpoint:
        lora, lcfg, _ = lora_lib.load_any_adapter(Path(args.checkpoint) / "adapter", CFG)
        scale = lcfg.scale
    return port_cli.run(args, CFG, tp, CharTokenizer(CFG), lora, scale, device="cpu")


def test_a_sampled_pass_is_seeded(setup, capsys):
    _, tp, files, _ = setup
    argv = [files["short"], "--model", "whisper-test", "--language", "english",
            "--max_new_tokens", "6", "--temperature", "0.7"]
    first, again = _port_run(argv, tp), _port_run(argv, tp)
    greedy = _port_run(argv[:-2], tp)
    assert first == again and first != greedy


def test_writers_equal_jax_render():
    segments = [(0.0, 1.24, " hello"), (None, 3.5, "world "), (3.5, None, "again"),
                (3661.0, 3662.001, "late")]
    words = [{"word": "hello", "start": 0.0, "end": 0.5, "probability": 0.9}]
    for fmt in twriters.WRITERS:
        for segs, ws in ((segments, words), (None, None), ([], None)):
            assert twriters.render(fmt, " some text ", segments=segs, words=ws) == \
                jwriters.render(fmt, " some text ", segments=segs, words=ws)
    assert twriters.SEGMENT_FORMATS == jwriters.SEGMENT_FORMATS


@pytest.mark.parametrize("flag,why", [(["--platform", "cpu"], "--device")])
def test_flags_not_in_the_port_are_refused(flag, why, capsys):
    with pytest.raises(SystemExit):
        port_cli.parse_args(["x.wav", *flag])
    assert why in capsys.readouterr().err


def test_main_end_to_end_on_the_cpu(setup, tmp_path, capsys):
    _, _, files, _ = setup
    out = tmp_path / "out.json"
    results = port_cli.main([files["short"], files["long"], "--model", "whisper-test",
                             "--language", "english", "--max_new_tokens", "4",
                             "--device", "cpu", "--output", str(out), "--output_format",
                             "srt", "--output_dir", str(tmp_path)])
    assert set(results) == set(files.values())
    assert json.loads(out.read_text()) == results
    assert (tmp_path / "short.srt").exists() and (tmp_path / "long.srt").exists()
