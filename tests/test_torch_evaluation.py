"""The port's evaluation workload against sar_tpu on the CPU: WER/CER
metrics (native and numpy paths) equal to JAX's on random strings; the
synthetic items, collated batches and loader order equal to JAX's;
`ASREvaluator(num_beams=2).evaluate` on a synthetic whisper-test split
(JAX weights bridged over, scaled x5 so that predictions depend on the
input) with predictions and WER equal to the JAX evaluator's; the
service's beam program; the evaluate CLI run in-process with an adapter
saved by the JAX package; and the loaders that wait for files refusing
clearly."""

import json
import sys

import jax
import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper, random_bank
from test_torch_decode_graphs import StandInSeam

from sar_tpu.data.collate import LIDCollator as JaxLIDCollator
from sar_tpu.data.collate import create_collator as jax_collator
from sar_tpu.data.datasets import create_dataset as jax_create_dataset
from sar_tpu.data.loader import DataLoader as JaxLoader
from sar_tpu.data.synthetic import SyntheticASRDataset as JaxSynthetic
from sar_tpu.evaluation.evaluator import ASREvaluator as JaxEvaluator
from sar_tpu.models import lora as jlora
from sar_tpu.training import metrics as jmetrics
from sar_tpu_torch.data import (CharTokenizer, DataLoader, LIDCollator,
                                SyntheticASRDataset, create_collator,
                                create_dataset, get_tokenizer)
from sar_tpu_torch.evaluation import ASREvaluator
from sar_tpu_torch.evaluation.evaluator import batch_transcribe, transcribe_audio
from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.base import load_base_model
from sar_tpu_torch.serving import TranscriptionService
from sar_tpu_torch.training import metrics as tmetrics
from sar_tpu_torch.utils import native

CFG = get_config("whisper-test")
NEW = 10


class IdTokenizer:
    """Every id as a word: WER over ids shows every token the decoders
    chose (CharTokenizer would drop the special ids)."""

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def model():
    return jax_whisper(CFG, seed=0, w_scale=5.0)


def _random_texts(rng, n):
    words = ["aba", "bob", "cud", "dig", "", "eel", "fog"]
    return [" ".join(rng.choice(words, size=rng.integers(0, 6))) for _ in range(n)]


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_metrics_equal_jax(path, monkeypatch):
    if path == "numpy":
        monkeypatch.setattr(native, "batch_edit_distance", lambda a, b: None)
    else:
        assert native.native_available() and native.ACTIVE_PATH == "native"
    rng = np.random.default_rng(4)
    preds, refs = _random_texts(rng, 40), _random_texts(rng, 40)
    preds[3], refs[5] = "", "  "
    assert tmetrics.compute_metrics(preds, refs) == jmetrics.compute_metrics(preds, refs)
    assert (tmetrics.compute_metrics_per_sample(preds, refs)
            == jmetrics.compute_metrics_per_sample(preds, refs))
    assert tmetrics.analyze_errors(preds, refs, 5) == jmetrics.analyze_errors(preds, refs, 5)
    for r, h in zip(refs[:10], preds[:10]):
        assert tmetrics.edit_distance(r.split(), h.split()) == \
            jmetrics.edit_distance(r.split(), h.split())


def test_synthetic_collate_and_loader_equal_jax():
    for lang, lid in (("english", 0), ("hindi", 2)):
        a, b = SyntheticASRDataset(CFG, size=5, language=lang, language_id=lid, seed=3), \
            JaxSynthetic(CFG, size=5, language=lang, language_id=lid, seed=3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["input_features"], y["input_features"])
            assert (x["labels"], x["text"], x["language_id"]) == \
                (y["labels"], y["text"], y["language_id"])
    ds = create_dataset("german", ["synthetic"], split="test", max_samples=7, seed=1,
                        model_config=CFG)
    jds = jax_create_dataset("german", ["synthetic"], split="test", max_samples=7, seed=1,
                             model_config=CFG)
    assert len(ds) == len(jds) == 7
    kw = dict(num_frames=CFG.num_audio_frames, pad_to_multiple=8, with_language=True)
    for shuffle, drop_last in ((True, True), (False, False)):
        got = list(DataLoader(ds, 3, create_collator(CFG.sot_token_id, **kw), shuffle=shuffle,
                              seed=5, drop_last=drop_last).one_epoch())
        want = list(JaxLoader(jds, 3, jax_collator(CFG.sot_token_id, **kw), shuffle=shuffle,
                              seed=5, drop_last=drop_last).one_epoch())
        assert len(got) == len(want) == (2 if drop_last else 3)
        assert len(DataLoader(ds, 3, None, drop_last=drop_last)) == len(got)
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and g["texts"] == w["texts"]
            for k in ("input_features", "labels", "language_ids"):
                np.testing.assert_array_equal(g[k], w[k])
    items = [ds[i] for i in range(3)]
    np.testing.assert_array_equal(LIDCollator(num_frames=8)(items)["input_features"],
                                  JaxLIDCollator(num_frames=8)(items)["input_features"])


def test_raw_audio_items_take_the_mel_frontend_on_the_given_device():
    rng = np.random.default_rng(2)
    items = [{"audio": rng.standard_normal(n).astype(np.float32) * 0.1, "labels": [4, 9, 3],
              "text": "x", "language_id": 0} for n in (8000, 12000)]
    batch = create_collator(CFG.sot_token_id, num_frames=CFG.num_audio_frames,
                            device="cpu")(items)
    feats = batch["input_features"]
    assert isinstance(feats, torch.Tensor) and feats.device.type == "cpu"
    assert feats.shape == (2, CFG.num_mel_bins, CFG.num_audio_frames)
    assert batch["labels"].tolist() == [[9, 3] + [-100] * 446] * 2


def _loaders(n=7, batch=3):
    kw = dict(num_frames=CFG.num_audio_frames)
    port = DataLoader(SyntheticASRDataset(CFG, size=n, seed=5), batch,
                      create_collator(CFG.sot_token_id, **kw), shuffle=False, drop_last=False)
    jax_side = JaxLoader(JaxSynthetic(CFG, size=n, seed=5), batch,
                         jax_collator(CFG.sot_token_id, **kw), shuffle=False, drop_last=False)
    return port, jax_side


@pytest.mark.parametrize("tokenizer", ["ids", "chars"])
def test_beam_evaluate_equals_jax_evaluator(model, tokenizer):
    """num_beams=2 through the whole workload. The JAX evaluator picks the
    classic cross layout on the CPU (beam_decode's auto head_minor), the
    port has the head-minor one; the two agree here token for token."""
    jp, tp = model
    tok = IdTokenizer() if tokenizer == "ids" else CharTokenizer(CFG)
    port_loader, jax_loader = _loaders()
    want = JaxEvaluator(CFG, jp, tok, language="english", max_new_tokens=NEW,
                        num_beams=2).evaluate(jax_loader, return_predictions=True)
    ev = ASREvaluator(CFG, tp, tok, language="english", max_new_tokens=NEW,
                      num_beams=2, device="cpu")
    got = ev.evaluate(port_loader, return_predictions=True)
    assert got == want
    assert got["num_samples"] == 7
    if tokenizer == "ids":
        assert len(set(got["predictions"])) > 1        # the input matters
        greedy = ASREvaluator(CFG, tp, tok, language="english", max_new_tokens=NEW,
                              device="cpu").evaluate(_loaders()[0], return_predictions=True)
        assert greedy["predictions"] != got["predictions"]
    jax.clear_caches()


def test_per_sample_analyze_and_save_results(model, tmp_path):
    _, tp = model
    ev = ASREvaluator(CFG, tp, CharTokenizer(CFG), language="english",
                      max_new_tokens=NEW, num_beams=2, device="cpu")
    port_loader, _ = _loaders(n=4, batch=2)
    per = ev.evaluate_per_sample(port_loader)
    out = ev.analyze(port_loader, top_k=3)
    assert [r["prediction"] for r in per] == out["predictions"]
    assert per == [dict(m, prediction=p, reference=r) for m, p, r in zip(
        jmetrics.compute_metrics_per_sample(out["predictions"], out["references"]),
        out["predictions"], out["references"])]
    assert out["error_analysis"] == jmetrics.analyze_errors(
        out["predictions"], out["references"], 3)
    ev.save_results(out, tmp_path)
    saved = json.loads((tmp_path / "metrics.json").read_text())
    assert saved["wer"] == out["wer"] and saved["num_samples"] == 4
    assert (tmp_path / "predictions.txt").read_text().splitlines() == out["predictions"]
    with pytest.raises(ValueError, match="tokenizer"):
        ASREvaluator(CFG, tp, device="cpu").evaluate(port_loader)


def test_batch_transcribe_matches_the_evaluator(model):
    _, tp = model
    rng = np.random.default_rng(6)
    clips = [rng.standard_normal(n).astype(np.float32) * 0.2 for n in (6000, 9000, 4000)]
    # batch_transcribe decodes as the JAX package's: exact encoder attention
    # and the unquantized classic cache.
    ev = ASREvaluator(CFG, tp, language="english", max_new_tokens=NEW, device="cpu",
                      kv_int8=False, flash=False)
    want = ev.from_audio(clips[:2]) + ev.from_audio(clips[2:])
    got = batch_transcribe(clips, CFG, tp, None, language="english", batch_size=2,
                           max_new_tokens=NEW, return_ids=True, device="cpu")
    assert got == want
    tok = IdTokenizer()
    assert transcribe_audio(clips[2], CFG, tp, tok, language="english",
                            max_new_tokens=NEW, device="cpu") == tok.decode(want[2])


@pytest.mark.parametrize("task", ["transcribe", "translate"])
def test_batch_transcribe_ids_equal_jax(model, task):
    """Three clips of different lengths in batches of 2 (the second padded
    with a silent clip): the port's ids equal JAX's batch_transcribe."""
    from sar_tpu.evaluation.evaluator import batch_transcribe as jax_batch_transcribe
    jp, tp = model
    rng = np.random.default_rng(12)
    clips = [rng.standard_normal(n).astype(np.float32) * 0.2 for n in (7000, 3000, 10000)]
    kw = dict(language="german", batch_size=2, max_new_tokens=NEW, task=task,
              return_ids=True)
    got = batch_transcribe(clips, CFG, tp, None, device="cpu", **kw)
    want = jax_batch_transcribe(clips, CFG, jp, None, **kw)
    assert got == want and len({tuple(r) for r in got}) > 1
    jax.clear_caches()


def test_the_plain_path_captures_once_across_calls(model, monkeypatch, tmp_path):
    """batch_transcribe keeps one program across calls, as JAX's
    module-level jit: two calls (another language: the prompt is refilled),
    two files through transcribe_long's plain path and two files through
    the transcribe CLI's default path capture each segment once, through
    one evaluator, with the ids of a fresh evaluator."""
    import wave

    from sar_tpu_torch.evaluation import evaluator, longform
    from sar_tpu_torch.scripts import transcribe as port_cli
    _, tp = model
    seams = []
    monkeypatch.setattr(evaluator, "_PLAIN", [])
    monkeypatch.setattr(evaluator, "resolve_capture", lambda capture, *a: capture is not False)
    monkeypatch.setattr(evaluator, "CudaGraphCapture",
                        lambda: seams.append(StandInSeam()) or seams[-1])
    rng = np.random.default_rng(13)
    clips = [rng.standard_normal(n).astype(np.float32) * 0.2 for n in (6000, 9000, 4000)]
    kw = dict(batch_size=2, max_new_tokens=NEW, return_ids=True, device="cpu")
    batch_transcribe(clips, CFG, tp, None, language="english", **kw)
    got = batch_transcribe(clips[::-1], CFG, dict(tp), None, language="german", **kw)
    fresh = ASREvaluator(CFG, tp, language="german", max_new_tokens=NEW, device="cpu",
                         kv_int8=False, flash=False, capture=False)
    assert got == fresh.from_audio(clips[:0:-1]) + fresh.from_audio(clips[:1])
    assert len(seams) == 1 and seams[0].captured == 1     # NEW = 10: one segment
    ev = evaluator._PLAIN[0][-1]
    tok = IdTokenizer()
    for n in (24000, 16000):
        audio = rng.standard_normal(n).astype(np.float32) * 0.2
        longform.transcribe_long(audio, CFG, tp, tok, language="english",
                                 max_new_tokens=NEW, chunk_seconds=0.6, batch_size=2,
                                 device="cpu")
    assert evaluator._PLAIN[0][-1] is ev and len(seams) == 1 and seams[0].captured == 1
    files = []
    for i in range(2):
        files.append(str(tmp_path / f"clip{i}.wav"))
        with wave.open(files[-1], "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((rng.standard_normal(8000) * 3000).astype(np.int16).tobytes())
    args = port_cli.parse_args([*files, "--model", "whisper-test", "--language", "english",
                                "--max_new_tokens", str(NEW), "--device", "cpu"])
    assert set(port_cli.run(args, CFG, tp, tok, device="cpu")) == set(files)
    # The CLI's default path decodes one file per batch of 8: a new shape,
    # one more program on the same evaluator (the old shape's dropped).
    assert evaluator._PLAIN[0][-1] is ev and len(seams) == 2
    assert [s.captured for s in seams] == [1, 1]


def test_weights_changed_in_place_are_not_decoded_stale(model, monkeypatch):
    """JAX's jit takes the weights on every call, so it always decodes
    their current values. The kept evaluator decodes with its own cast of
    a float64 adapter bank: after the caller updates the bank in place, the
    next call builds a fresh evaluator. It decodes the fp32 params as they
    are: after an update of those in place it is kept, and gives a fresh
    evaluator's ids."""
    from sar_tpu_torch.evaluation import evaluator
    _, tp = model
    monkeypatch.setattr(evaluator, "_PLAIN", [])
    params = whisper.tree_map(torch.clone, tp)
    bank = whisper.tree_map(lambda t: t.double(), random_bank(CFG, 1, 4, seed=3)[1])
    rng = np.random.default_rng(15)
    clips = [rng.standard_normal(6000).astype(np.float32) * 0.2 for _ in range(2)]
    kw = dict(language="english", batch_size=2, max_new_tokens=NEW, return_ids=True,
              device="cpu", lora=bank, lora_scale=4.0)

    def fresh():
        return ASREvaluator(CFG, params, language="english", max_new_tokens=NEW,
                            lora=bank, lora_scale=4.0, device="cpu", kv_int8=False,
                            flash=False).from_audio(clips)

    first = batch_transcribe(clips, CFG, params, None, **kw)
    ev = evaluator._PLAIN[0][-1]
    assert batch_transcribe(clips, CFG, params, None, **kw) == first
    assert evaluator._PLAIN[0][-1] is ev
    for t in whisper.tree_leaves(bank):
        t.mul_(-40.0)
    got = batch_transcribe(clips, CFG, params, None, **kw)
    assert evaluator._PLAIN[0][-1] is not ev and got == fresh() and got != first
    ev = evaluator._PLAIN[0][-1]
    with torch.no_grad():
        params["decoder"]["token_embed"].mul_(-1.0)
    got = batch_transcribe(clips, CFG, params, None, **kw)
    assert evaluator._PLAIN[0][-1] is ev and got == fresh()


def test_the_kept_evaluator_serves_threads_one_call_at_a_time(model, monkeypatch):
    """Threads that call batch_transcribe at once, in two languages, share
    the kept evaluator one call at a time: each gets a fresh evaluator's
    ids for its language, and one evaluator is kept."""
    import threading

    from sar_tpu_torch.evaluation import evaluator
    _, tp = model
    monkeypatch.setattr(evaluator, "_PLAIN", [])
    rng = np.random.default_rng(14)
    clips = [rng.standard_normal(5000).astype(np.float32) * 0.2 for _ in range(2)]
    langs = ("english", "german")
    want = {lang: ASREvaluator(CFG, tp, language=lang, max_new_tokens=NEW, device="cpu",
                               kv_int8=False, flash=False).from_audio(clips)
            for lang in langs}
    got = [None] * 12
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(i, batch_transcribe(
            clips, CFG, tp, None, language=langs[i % 2], batch_size=2, max_new_tokens=NEW,
            return_ids=True, device="cpu"))) for i in range(len(got))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert got == [want[langs[i % 2]] for i in range(len(got))]
    assert len(evaluator._PLAIN) == 1


def test_service_beam_program_matches_the_evaluator(model):
    _, tp = model
    rng = np.random.default_rng(8)
    clips = [rng.standard_normal(n).astype(np.float32) * 0.2 for n in (5000, 7000, 3000)]
    langs = ["english", "german", "english"]
    with TranscriptionService(CFG, tp, language="english", batch_size=3, max_wait_ms=300.0,
                              max_new_tokens=NEW, num_beams=3, device="cpu") as svc:
        handles = [svc.submit(c, lang) for c, lang in zip(clips, langs)]
        got = [h.result(timeout=300.0) for h in handles]
    ev = ASREvaluator(CFG, tp, language="english", max_new_tokens=NEW, num_beams=3,
                      device="cpu")
    from sar_tpu_torch.ops import mel
    feats = mel.log_mel_spectrogram(torch.from_numpy(mel.stack_pad_audio(clips)),
                                    CFG.num_mel_bins)[:, :, :CFG.num_audio_frames]
    prompts = torch.tensor([CFG.prompt_ids(lang) for lang in langs])
    from sar_tpu_torch.decode import transcribe_tokens
    want = transcribe_tokens(ev.beam(feats, prompts), CFG, len(prompts[0]))
    assert got == want
    assert want != transcribe_tokens(ev.dec(ev.prep(feats), prompts), CFG, len(prompts[0]))


def test_evaluate_cli_in_process(model, tmp_path, capsys):
    from sar_tpu_torch.scripts import evaluate_model
    jb, _ = random_bank(CFG, 1, 4, seed=3)
    jlora.save_adapter(tmp_path / "run" / "adapter", jb, jlora.LoraConfig(r=4, alpha=8))
    out = tmp_path / "eval"
    res = evaluate_model.main([
        "--checkpoint", str(tmp_path / "run"), "--model", "whisper-test",
        "--language", "english", "--data_sources", "synthetic", "--num_beams", "2",
        "--device", "cpu", "--max_samples", "5", "--batch_size", "2",
        "--max_new_tokens", "8", "--mixed_precision", "no", "--output_dir", str(out),
        "--save_predictions", "--per_sample"])
    printed = capsys.readouterr().out
    assert f"WER: {res['wer'] * 100:.2f}%" in printed and "Samples: 5" in printed
    saved = json.loads((out / "metrics.json").read_text())
    assert saved == {k: res[k] for k in ("wer", "cer", "num_samples")}
    assert len(json.loads((out / "per_sample.json").read_text())) == 5
    assert len((out / "predictions.txt").read_text().splitlines()) == 5
    base = dict(res)
    none = evaluate_model.main([
        "--checkpoint", "none", "--model", "whisper-test", "--language", "english",
        "--data_sources", "synthetic", "--num_beams", "2", "--device", "cpu",
        "--max_samples", "5", "--batch_size", "2", "--max_new_tokens", "8",
        "--mixed_precision", "no", "--save_predictions", "--output_dir", str(out)])
    assert none["num_samples"] == 5 and none["references"] == base["references"]
    with pytest.raises(SystemExit):
        evaluate_model.main(["--checkpoint", str(tmp_path / "nothing"), "--model",
                             "whisper-test", "--language", "english", "--data_sources",
                             "synthetic", "--device", "cpu"])


@pytest.mark.parametrize("extra", [["--cache_dir", "x"], ["--attn_scores", "int8", "--kv_cache", "int4"],
                                   ["--tp", "2"], ["--dcn_dp", "2"]])
def test_evaluate_cli_refuses_flags_not_ported(extra, capsys):
    """The flags the port has not got fail at parsing; a mesh flag is
    ported and, in one process, exits naming the devices it needs."""
    from sar_tpu_torch.scripts import evaluate_model
    argv = ["--checkpoint", "none", "--language", "english", *extra]
    if extra[0] in ("--tp", "--dcn_dp"):
        with pytest.raises(SystemExit, match="needs 2 devices but 1 is running"):
            evaluate_model.main([*argv, "--device", "cpu"])
        return
    with pytest.raises(SystemExit):
        evaluate_model.parse_args(argv)
    assert "sar_tpu_torch" in capsys.readouterr().err


def test_evaluate_cli_under_torchrun_equals_one_process(tmp_path):
    """`torchrun --nproc_per_node 2 ... --dp 2`: two gloo ranks, each
    transcribing its rows; metrics.json equals a one-process run's, and
    rank 0 alone prints and writes."""
    import os
    import subprocess

    from sar_tpu_torch.scripts import evaluate_model
    argv = ["--checkpoint", "none", "--model", "whisper-test", "--language", "english",
            "--data_sources", "synthetic", "--max_samples", "6", "--batch_size", "4",
            "--max_new_tokens", "6", "--mixed_precision", "no", "--device", "cpu"]
    evaluate_model.main([*argv, "--output_dir", str(tmp_path / "one")])
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([os.getcwd(), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "sar_tpu_torch.scripts.evaluate_model", *argv,
         "--dp", "2", "--output_dir", str(tmp_path / "two")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("WER: ") == 1 and proc.stdout.count("Samples: 6") == 1
    assert (json.loads((tmp_path / "two" / "metrics.json").read_text())
            == json.loads((tmp_path / "one" / "metrics.json").read_text()))
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) == ["metrics.json"]


def test_loaders_that_wait_for_files_refuse_clearly(monkeypatch):
    assert isinstance(get_tokenizer("whisper-test"), CharTokenizer)
    monkeypatch.setitem(sys.modules, "transformers", None)   # as without the package
    with pytest.raises(RuntimeError, match="not available offline"):
        get_tokenizer("whisper-small", language="hindi")
    for sources in (["common_voice"], ["synthetic", "fleurs"], None):
        with pytest.raises(NotImplementedError, match="synthetic"):
            create_dataset("hindi", sources, model_config=CFG)
    with pytest.raises(NotImplementedError, match="weights"):
        load_base_model("whisper-small")
    cfg, p = load_base_model("whisper-test", dtype=torch.float32, seed=3)
    cfg2, p2 = load_base_model("whisper-test", dtype=torch.float32, seed=3)
    assert cfg == cfg2 and cfg.d_model == CFG.d_model and torch.equal(p["decoder"]["token_embed"], p2["decoder"]["token_embed"])
    assert load_base_model("whisper-test")[1]["decoder"]["token_embed"].dtype == torch.bfloat16


def test_new_port_modules_import_neither_jax_nor_sar_tpu():
    import subprocess
    from pathlib import Path
    code = ("import sys\n"
            "import sar_tpu_torch.decode.beam, sar_tpu_torch.data, sar_tpu_torch.models.base\n"
            "import sar_tpu_torch.training.metrics, sar_tpu_torch.utils.native\n"
            "import sar_tpu_torch.scripts.evaluate_model, sar_tpu_torch.evaluation\n"
            "import sar_tpu_torch.scripts.s8_gate, sar_tpu_torch.utils.logging\n"
            "import sar_tpu_torch.analysis, sar_tpu_torch.models.convert\n"
            "import sar_tpu_torch.scripts.lid_sweep, sar_tpu_torch.scripts.route_infer\n"
            "import sar_tpu_torch.scripts.analyze_adapters, sar_tpu_torch.models.router\n"
            "import sar_tpu_torch.training.lid_trainer\n"
            "import sar_tpu_torch.data.preprocessing, sar_tpu_torch.decode.timestamps\n"
            "import sar_tpu_torch.decode.align, sar_tpu_torch.evaluation.fallback\n"
            "import sar_tpu_torch.evaluation.longform, sar_tpu_torch.evaluation.writers\n"
            "import sar_tpu_torch.evaluation.hallucination, sar_tpu_torch.scripts.transcribe\n"
            "import sar_tpu_torch.decode.graphs, sar_tpu_torch.evaluation.streaming\n"
            "import sar_tpu_torch.scripts.serve, sar_tpu_torch.data.datasets\n"
            "import sar_tpu_torch.parallel.sharding, sar_tpu_torch.parallel.distributed\n"
            "import sar_tpu_torch.scripts.train_lora, sar_tpu_torch.scripts.train_router\n"
            "import sar_tpu_torch.scripts.benchmark\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'sar_tpu' or m.startswith('sar_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1], timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
