"""The port's Phase 2 CLIs (sar_tpu_torch/scripts/route_infer.py and
lid_sweep.py) against the JAX package's scripts on the CPU, whisper-test.

route_infer: the JAX script's `main` and the port's `route` on the same
weights (JAX's `load_base_model("whisper-test")` bridged with
from_jax_params), one JAX-saved random adapter per language and a
JAX-saved random classifier, two languages, fp32, `--oracle`: the LID
accuracy, every utterance's detected language, the routed and oracle
tokens of every batch, and each language's entry (routed WER/CER, oracle
WER, the gap, num_samples) and the overall metrics equal exactly; both
write routing_results.json. The base weights are JAX's init with every
weight matrix x 5 (as _torch_port.jax_whisper), so that the tokens depend
on the input. The port's `main`
also runs end to end, and its refusals.

lid_sweep: the JAX script's `main` and the port's `sweep` over a 2-layer x
2-pooling grid with JAX's bf16 base params (its init, weight matrices x 5
as in _torch_port.jax_whisper) and each cell's JAX head bridged over.
Dropout is set to 0 in both packages' ClassifierConfig for this (JAX
draws its masks from jax.random, the port from a torch generator).
Accuracy, per-class accuracy and the confusion matrices equal exactly. The
eval loss (rounded to 4 places by both scripts) is held to 2^-7 relative,
two bf16 ulps, plus the rounding's 5e-5: the sweep's features are bf16,
and XLA and torch round them differently on the CPU (about half the
entries differ by an ulp), which moves the trained heads' losses by up to
~5e-3 relative; PR 12's 1e-5 (tests/test_torch_lid_trainer.py) holds for
fp32 features only. The default cell follows the rule of both scripts:
the highest accuracy, ties to the cheapest tap by each run's own timing,
so the chosen cell equals JAX's unless a tie is broken by the clock.
"""

import dataclasses
import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import get_config, to_numpy

from sar_tpu.models import classifier as jclf
from sar_tpu.models import lora as jlora
from sar_tpu.models import whisper as jw
from sar_tpu.models.router import AdapterRouter as JaxRouter
from sar_tpu_torch.data import CharTokenizer
from sar_tpu_torch.models import classifier as tclf
from sar_tpu_torch.models.convert import from_jax_params
from sar_tpu_torch.models.router import AdapterRouter
from sar_tpu_torch.scripts import lid_sweep, route_infer

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import lid_sweep as jax_lid_sweep  # noqa: E402
import route_infer as jax_route_infer  # noqa: E402

CFG = get_config("whisper-test")
LANGS = ("english", "german")
LOSS_RTOL, ROUND = 2.0 ** -7, 5e-5
W_SCALE = 5.0


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A JAX-saved random adapter per language (r=4, q/v, nonzero B) and a
    JAX-saved random LID head at layer 0."""
    root = tmp_path_factory.mktemp("routed")
    lcfg = jlora.LoraConfig(r=4, alpha=8, dropout=0.0)
    for i, lang in enumerate(LANGS):
        bank = jlora.init_lora(jax.random.PRNGKey(i), CFG, lcfg)
        leaves, td = jax.tree.flatten(bank)
        keys = jax.random.split(jax.random.PRNGKey(10 + i), len(leaves))
        bank = jax.tree.unflatten(td, [jax.random.normal(k, l.shape) * 0.1
                                       for k, l in zip(keys, leaves)])
        jlora.save_adapter(root / lang, bank, lcfg, metadata={"language": lang})
    ccfg = jclf.ClassifierConfig(input_dim=CFG.d_model, hidden_dims=(16,),
                                 num_classes=len(LANGS), dropout=0.0,
                                 languages=LANGS, encoder_layer=0)
    jclf.save_classifier(root / "router" / "classifier",
                         jclf.init_classifier(jax.random.PRNGKey(7), ccfg), ccfg)
    return root


def _route_argv(root, out, *extra):
    return ["--model", "whisper-test", "--classifier", str(root / "router"),
            "--adapters", *[f"{l}={root / l}" for l in LANGS],
            "--data_sources", "synthetic", "--max_samples", "4", "--batch_size", "4",
            "--max_new_tokens", "10", "--mixed_precision", "no", "--oracle",
            "--output_dir", str(out), *extra]


def _spy(monkeypatch, cls, detected, tokens):
    """Record every detect_language call's detected languages and every
    generate call's tokens (as numpy)."""
    detect, generate = cls.detect_language, cls.generate

    def spy_detect(self, feats):
        out = detect(self, feats)
        detected.extend(out[0])
        return out

    def spy_generate(self, *a, **kw):
        out = generate(self, *a, **kw)
        tokens.append(np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out))
        return out
    monkeypatch.setattr(cls, "detect_language", spy_detect)
    monkeypatch.setattr(cls, "generate", spy_generate)


def test_route_infer_equals_the_jax_cli(dirs, tmp_path, monkeypatch):
    monkeypatch.setattr(jw, "init_params", functools.partial(_scaled_init, jw.init_params))
    jax_detected, port_detected, jax_tokens, port_tokens = [], [], [], []
    _spy(monkeypatch, JaxRouter, jax_detected, jax_tokens)
    _spy(monkeypatch, AdapterRouter, port_detected, port_tokens)
    want = jax_route_infer.main(_route_argv(dirs, tmp_path / "jax"))

    from sar_tpu.models.base import load_base_model as jax_load
    _, jp = jax_load("whisper-test", dtype=jnp.float32)
    args = route_infer.parse_args(_route_argv(dirs, tmp_path / "port", "--device", "cpu",
                                              "--router_dir", str(tmp_path / "saved")))
    got, router = route_infer.route(args, CFG, from_jax_params(to_numpy(jp)),
                                    CharTokenizer(CFG), torch.device("cpu"))

    # 8 utterances in 2 mixed batches of 4: LID once per batch plus the
    # overhead's 3 repetitions on the last batch; a routed and an oracle
    # decode per batch, token for token the JAX router's.
    assert len(port_detected) == len(jax_detected) == 8 + 3 * 4
    assert port_detected == jax_detected
    assert len(port_tokens) == len(jax_tokens) == 4
    for g, w in zip(port_tokens, jax_tokens):
        np.testing.assert_array_equal(g, w)
    assert got["lid_accuracy"] == want["lid_accuracy"]
    assert got["per_language"] == want["per_language"]
    assert got["overall"] == want["overall"]
    assert set(got) == set(want) and got["strategy"] == "hard"
    assert all(e["num_samples"] == 4 for e in got["per_language"].values())
    assert got["routing_overhead_ms"] > 0
    for side in ("jax", "port"):
        saved = json.loads((tmp_path / side / "routing_results.json").read_text())
        assert saved["per_language"] == want["per_language"]
    # The saved router reloads with the same bank, head and strategy.
    again = AdapterRouter.load(tmp_path / "saved", CFG, router.base_params, device="cpu")
    assert again.languages == list(LANGS) and again.strategy == "hard"
    for side, hooks in router.bank.items():
        for hook, e in hooks.items():
            for k, v in e.items():
                assert torch.equal(again.bank[side][hook][k], v)


def test_route_infer_main_end_to_end_and_refusals(dirs, tmp_path, capsys):
    results = route_infer.main(_route_argv(dirs, tmp_path, "--device", "cpu"))
    assert set(results["per_language"]) == set(LANGS)
    assert 0.0 <= results["lid_accuracy"] <= 1.0
    assert json.loads((tmp_path / "routing_results.json").read_text()) == json.loads(
        json.dumps(results))
    for extra in (["--platform", "cpu"], ["--cache_dir", "x"]):
        with pytest.raises(SystemExit):
            route_infer.parse_args(_route_argv(dirs, tmp_path, *extra))
        assert "sar_tpu_torch" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="missing adapters"):
        route_infer.main(["--model", "whisper-test", "--classifier", str(dirs / "router"),
                          "--adapters", f"english={dirs / 'english'}",
                          "--data_sources", "synthetic", "--device", "cpu"])


SWEEP = ["--model", "whisper-test", "--languages", *LANGS, "--layers", "0", "-1",
         "--poolings", "mean", "attention", "--samples_per_language", "12",
         "--eval_samples_per_language", "6", "--batch_size", "8", "--max_steps", "6",
         "--warmup_steps", "2", "--learning_rate", "1e-3", "--seed", "3", "--iters", "2"]


def _scaled_init(init, key, cfg):
    """JAX's init with every weight matrix x W_SCALE (as
    _torch_port.jax_whisper): at the init's std of 0.02 whisper-test's bf16
    features vary less across utterances than the two frameworks' bf16
    rounding differs, and the rounding would decide the heads."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (x * W_SCALE if getattr(path[-1], "key", None) == "w"
                         and x.ndim >= 2 else x), init(key, cfg))


def test_lid_sweep_equals_the_jax_cli(tmp_path, monkeypatch):
    monkeypatch.setattr(jclf, "ClassifierConfig",
                        functools.partial(jclf.ClassifierConfig, dropout=0.0))
    monkeypatch.setattr(jw, "init_params", functools.partial(_scaled_init, jw.init_params))
    jax_lid_sweep.main(SWEEP + ["--output", str(tmp_path / "jax.json")])
    want = json.loads((tmp_path / "jax.json").read_text())

    args = lid_sweep.parse_args(SWEEP + ["--device", "cpu",
                                         "--output", str(tmp_path / "port.json")])
    jp = jw.cast_params(jw.init_params(jax.random.PRNGKey(args.seed), CFG), jnp.bfloat16)
    assert np.abs(np.asarray(jp["encoder"]["layers"]["q"]["w"], np.float32)).max() > 0.2
    heads = {}
    for layer in args.layers:
        for pooling in args.poolings:
            jccfg = jclf.ClassifierConfig(input_dim=CFG.d_model, num_classes=len(LANGS),
                                          pooling=pooling, languages=LANGS,
                                          encoder_layer=layer)
            assert jccfg.dropout == 0.0
            heads[layer, pooling] = (
                tclf.ClassifierConfig(**dataclasses.asdict(jccfg)),
                from_jax_params(to_numpy(jclf.init_classifier(
                    jax.random.PRNGKey(args.seed), jccfg))))
    got = lid_sweep.sweep(args, CFG, from_jax_params(to_numpy(jp)), torch.device("cpu"),
                          heads=heads)
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(json.dumps(got))

    assert [k for k in got if k != "backend"] == [k for k in want if k != "backend"]
    assert got["backend"] == "cpu"
    assert len(got["results"]) == len(want["results"]) == 4
    for g, w in zip(got["results"], want["results"]):
        assert set(g) == set(w)
        for k in ("encoder_layer", "pooling", "accuracy", "per_class_accuracy",
                  "confusion_matrix"):
            assert g[k] == w[k], k
        assert sum(map(sum, g["confusion_matrix"])) == 6 * len(LANGS)
        np.testing.assert_allclose(g["eval_loss"], w["eval_loss"], rtol=LOSS_RTOL, atol=ROUND)
        assert g["lid_ms_per_utt"] > 0
    for report in (got, want):
        best = max(report["results"], key=lambda r: (r["accuracy"], -r["lid_ms_per_utt"]))
        assert report["chosen_default"] == {k: best[k] for k in (
            "encoder_layer", "pooling", "accuracy", "lid_ms_per_utt")}
    assert got["chosen_default"]["accuracy"] == want["chosen_default"]["accuracy"]
    tied = [r for r in want["results"] if r["accuracy"] == want["chosen_default"]["accuracy"]]
    if len({r["encoder_layer"] for r in tied}) == 1:
        # No tie between taps for the clock to break: the same cell (the
        # first of the tied poolings in both).
        assert got["chosen_default"] | {"lid_ms_per_utt": 0} == \
            want["chosen_default"] | {"lid_ms_per_utt": 0}


def test_lid_sweep_main_refuses_platform(capsys):
    with pytest.raises(SystemExit):
        lid_sweep.parse_args(["--platform", "cpu"])
    assert "sar_tpu_torch" in capsys.readouterr().err
