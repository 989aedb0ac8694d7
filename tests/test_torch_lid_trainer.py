"""The port's LID training (training/lid_trainer.py, the classifier's
dropout, scripts/train_router.py) against sar_tpu's LIDTrainer on the CPU:
whisper-test at fp32 with the JAX-made weights and head bridged over, two
synthetic languages, dropout 0 (JAX draws its masks from jax.random, the
port from a torch generator). Tolerances: per-step losses 1e-5 relative
and 1e-6 absolute (fp32, the encoder's and the head's sums in other
orders), encoder features 1e-4 absolute; accuracies and confusion
matrices exactly equal. Also: the checkpoint round trip and a resume, the
encoder-layer refusals, the three faults of the JAX side that the port
does not copy, the dropout's statistics, and train_router end to end into
a router built by build_router_from_checkpoints."""

import json
import logging

import jax
import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper, t, to_numpy

from sar_tpu.data.collate import LIDCollator as JaxLIDCollator
from sar_tpu.data.loader import DataLoader as JaxDataLoader
from sar_tpu.data.synthetic import SyntheticASRDataset as JaxSynthetic
from sar_tpu.models import classifier as jclf
from sar_tpu.training import lid_trainer as jlid
from sar_tpu_torch.data import DataLoader, LIDCollator, SyntheticASRDataset
from sar_tpu_torch.models import classifier as tclf
from sar_tpu_torch.models import lora as tlora
from sar_tpu_torch.models.convert import from_jax_params
from sar_tpu_torch.models.router import build_router_from_checkpoints
from sar_tpu_torch.models.whisper import tree_leaves
from sar_tpu_torch.scripts import train_router
from sar_tpu_torch.training.lid_trainer import LIDDataset, LIDTrainer, LIDTrainingArgs

CFG = get_config("whisper-test")
LANGS = ("english", "german")
ARGS = dict(learning_rate=5e-3, weight_decay=0.01, warmup_steps=2, max_steps=6,
            eval_steps=3, scheduler="cosine", mixed_precision="no", seed=3)


@pytest.fixture(scope="module")
def world():
    jp, tp = jax_whisper(CFG, seed=0)
    jds = {l: JaxSynthetic(CFG, size=20, language=l, language_id=i, seed=i)
           for i, l in enumerate(LANGS)}
    tds = {l: SyntheticASRDataset(CFG, size=20, language=l, language_id=i, seed=i)
           for i, l in enumerate(LANGS)}
    return jp, tp, jds, tds


def _heads(encoder_layer, pooling="mean", seed=5):
    jccfg = jclf.ClassifierConfig(input_dim=CFG.d_model, hidden_dims=(16,), num_classes=2,
                                  dropout=0.0, pooling=pooling, label_smoothing=0.1,
                                  languages=LANGS, encoder_layer=encoder_layer)
    jcp = jclf.init_classifier(jax.random.PRNGKey(seed), jccfg)
    return (jccfg, jcp, tclf.ClassifierConfig.from_dict(jccfg.to_dict()),
            from_jax_params(to_numpy(jcp)))


def _loaders(jds, tds, batch, drop_last=True, shuffle=True):
    jl = JaxDataLoader(jlid.LIDDataset(jds, LANGS), batch, JaxLIDCollator(), seed=0,
                       shuffle=shuffle, drop_last=drop_last)
    tl = DataLoader(LIDDataset(tds, LANGS), batch, LIDCollator(), seed=0,
                    shuffle=shuffle, drop_last=drop_last)
    return jl, tl


def _trainers(world, encoder_layer=0, accum=1, pooling="mean"):
    jp, tp, _, _ = world
    jccfg, jcp, tccfg, tcp = _heads(encoder_layer, pooling)
    kw = dict(ARGS, gradient_accumulation_steps=accum, encoder_layer=encoder_layer)
    return (jlid.LIDTrainer(CFG, jp, jcp, jccfg, jlid.LIDTrainingArgs(**kw)),
            LIDTrainer(CFG, tp, tcp, tccfg, LIDTrainingArgs(device="cpu", **kw)))


def _same_eval(got, want):
    assert got["confusion_matrix"] == want["confusion_matrix"]
    assert got["accuracy"] == want["accuracy"]
    assert got["per_class_accuracy"] == want["per_class_accuracy"]
    assert got["num_samples"] == want["num_samples"]
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-5, atol=1e-6)


# Streaming training (the encoder on every microbatch) with 2-step
# accumulation, at the final output (-1) and a tap layer (0).
@pytest.mark.parametrize("encoder_layer", [-1, 0])
def test_train_losses_accuracy_and_confusion_match_jax(world, encoder_layer):
    _, _, jds, tds = world
    jt, tt = _trainers(world, encoder_layer, accum=2)
    jl, tl = _loaders(jds, tds, 8)
    jel, tel = _loaders(jds, tds, 8, drop_last=False, shuffle=False)
    want = jt.train(jl, jel)
    got = tt.train(tl, tel)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=1e-6)
    assert len(got["loss"]) == ARGS["max_steps"]
    assert [e["step"] for e in got["eval"]] == [e["step"] for e in want["eval"]] == [0, 3, 6]
    for g, w in zip(got["eval"], want["eval"]):
        _same_eval(g, w)
    jax.clear_caches()


def test_cached_features_train_and_evaluate_match_jax(world):
    """The frozen-feature cache: the same features, the same per-step
    losses over the same permutations (one microbatch per step, a dataset
    size divisible by the batch), the same evaluation."""
    _, _, jds, tds = world
    jt, tt = _trainers(world, encoder_layer=0)
    jl, tl = _loaders(jds, tds, 8, drop_last=False, shuffle=False)
    jf, jlab = jt.precompute_features(jl)
    tf, tlab = tt.precompute_features(tl)
    assert tf.shape == (40, CFG.max_source_positions, CFG.d_model)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-4, rtol=0)
    assert tlab.tolist() == np.asarray(jlab).tolist()
    want = jt.train_cached(jf, jlab, batch_size=8, eval_feats=jf, eval_labels=jlab)
    got = tt.train_cached(tf, tlab, batch_size=8, eval_feats=tf, eval_labels=tlab)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, atol=1e-6)
    for g, w in zip(got["eval"], want["eval"]):
        _same_eval(g, w)
    jax.clear_caches()


def test_checkpoint_round_trip_and_resume(world, tmp_path):
    _, _, _, tds = world
    _, tt = _trainers(world, encoder_layer=0)
    tl = DataLoader(LIDDataset(tds, LANGS), 8, LIDCollator(), seed=0)
    tt.args.max_steps = 2
    tt.train(tl)
    tt.best_metric = 0.5
    tt.save_checkpoint(tmp_path / "ck")
    assert {p.name for p in (tmp_path / "ck").iterdir()} == {
        "classifier_config.json", "classifier_params.npz", "train_state.pt"}
    _, fresh = _trainers(world, encoder_layer=0)
    fresh.load_checkpoint(tmp_path / "ck")
    assert (fresh.global_step, fresh.best_metric) == (2, 0.5)
    for a, b in zip(tree_leaves(tt.params), tree_leaves(fresh.params)):
        assert torch.equal(a, b) and b.requires_grad
    assert fresh.opt_state["count"] == tt.opt_state["count"] == 2
    for k in ("mu", "nu"):
        for a, b in zip(tree_leaves(tt.opt_state[k]), tree_leaves(fresh.opt_state[k])):
            assert torch.equal(a, b)
    # The saved head is the JAX package's format: sar_tpu loads it.
    jparams, jccfg, meta = jclf.load_classifier(tmp_path / "ck")
    assert jccfg.encoder_layer == 0 and meta["global_step"] == 2
    np.testing.assert_array_equal(np.asarray(jparams["out"]["w"]),
                                  tt.params["out"]["w"].detach().numpy())
    # A resume trains the remaining steps only, from the restored state.
    fresh.args.max_steps = 4
    hist = fresh.train(tl)
    assert len(hist["loss"]) == 2 and fresh.global_step == 4 \
        and fresh.opt_state["count"] == 4


def test_encoder_layer_mismatch_is_refused(world, tmp_path):
    _, tp, _, _ = world
    _, _, tccfg, tcp = _heads(0)
    with pytest.raises(ValueError, match="encoder_layer"):
        LIDTrainer(CFG, tp, tcp, tccfg, LIDTrainingArgs(encoder_layer=-1, device="cpu"))
    tclf.save_classifier(tmp_path / "c", tcp, tccfg)
    _, _, ccfg_final, cp_final = _heads(-1)
    tr = LIDTrainer(CFG, tp, cp_final, ccfg_final,
                    LIDTrainingArgs(encoder_layer=-1, device="cpu"))
    with pytest.raises(ValueError, match="encoder_layer=0"):
        tr.load_checkpoint(tmp_path / "c")
    # A mesh is taken (it was refused before the port had meshes): on one
    # process it trains as without one; the feature cache refuses it, as
    # the JAX trainer's does.
    from _torch_port import one_process_mesh
    batch = next(iter(DataLoader(LIDDataset(world[3], LANGS), 4, LIDCollator(),
                                 seed=0).one_epoch()))
    want = LIDTrainer(CFG, tp, cp_final, ccfg_final,
                      LIDTrainingArgs(device="cpu", mixed_precision="no")).train_step([batch])
    with one_process_mesh(tmp_path) as mesh:
        tr = LIDTrainer(CFG, tp, cp_final, ccfg_final,
                        LIDTrainingArgs(device="cpu", mixed_precision="no"), mesh=mesh)
        assert float(tr.train_step([batch])) == pytest.approx(float(want), rel=1e-6)
        with pytest.raises(NotImplementedError, match="feature caching"):
            tr.precompute_features(None)


def test_reference_faults_are_not_copied(world, tmp_path, caplog):
    """(1) --cache_features caches every training sample (the JAX script
    reads its drop_last train loader: 20 of 2 x 10 samples at batch 8
    become 16); (2) --cache_features with accumulation > 1 is refused, and
    so is train_cached itself; (3) evaluate_cached follows a
    load_checkpoint (JAX memoises a step bound to the old config); (4)
    --encoder_layer keeps JAX's default of -1."""
    _, _, _, tds = world
    base = ["--base_model", "whisper-test", "--languages", *LANGS, "--data_sources",
            "synthetic", "--hidden_dims", "16", "--samples_per_language", "10",
            "--batch_size", "8", "--max_steps", "3", "--eval_steps", "3",
            "--mixed_precision", "no", "--no_wandb", "--device", "cpu"]
    with caplog.at_level(logging.INFO, logger="train_router"):
        train_router.main([*base, "--cache_features", "--output_dir", str(tmp_path / "a")])
    assert "cached 20 train" in caplog.text
    with pytest.raises(SystemExit):
        train_router.parse_args([*base, "--cache_features", "--gradient_accumulation_steps",
                                 "2", "--output_dir", str(tmp_path / "b")])
    _, tt = _trainers(world, encoder_layer=0, accum=2)
    with pytest.raises(ValueError, match="one microbatch per step"):
        tt.train_cached(torch.zeros((8, 4, CFG.d_model)), torch.zeros(8, dtype=torch.long))

    _, tt = _trainers(world, encoder_layer=0, pooling="mean")
    tl = DataLoader(LIDDataset(tds, LANGS), 8, LIDCollator(), shuffle=False, drop_last=False)
    feats, labels = tt.precompute_features(tl)
    tt.evaluate_cached(feats, labels)
    _, other = _trainers(world, encoder_layer=0, pooling="max")
    other.save_checkpoint(tmp_path / "max_head")
    tt.load_checkpoint(tmp_path / "max_head")
    assert tt.clf_cfg.pooling == "max"
    _same_eval(tt.evaluate_cached(feats, labels), other.evaluate_cached(feats, labels))
    assert train_router.parse_args([*base, "--output_dir", "x"]).encoder_layer == -1


def test_classifier_dropout_statistics():
    """Dropout > 0 (the JAX masks come from jax.random, so it is held to
    its statistics): keep rate 1 - p, kept entries scaled by 1 / (1 - p),
    the identity at inference; one generator seed, one mask."""
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(0)
    y = tclf._dropout(x, 0.3, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert tclf._dropout(x, 0.3, None) is x
    ccfg = tclf.ClassifierConfig(input_dim=32, hidden_dims=(64, 32), num_classes=3,
                                 dropout=0.5, languages=("a", "b", "c"))
    p = tclf.init_classifier(torch.Generator().manual_seed(1), ccfg)
    h = torch.randn((4, 10, 32), generator=torch.Generator().manual_seed(2))
    infer = tclf.apply_classifier(p, ccfg, h)["logits"]
    assert torch.equal(infer, tclf.apply_classifier(
        p, ccfg, h, train=True, generator=None)["logits"])
    run = lambda s: tclf.apply_classifier(p, ccfg, h, train=True,
                                          generator=torch.Generator().manual_seed(s))["logits"]
    assert torch.equal(run(7), run(7)) and not torch.equal(run(7), run(8))
    assert not torch.allclose(run(7), infer)


def test_train_router_cli_into_a_router(world, tmp_path):
    """train_router trains, saves and reloads a head (a resume trains the
    remaining steps); build_router_from_checkpoints routes with it over two
    adapter directories."""
    _, _, _, tds = world
    out = tmp_path / "router"
    base = ["--base_model", "whisper-test", "--languages", *LANGS, "--data_sources",
            "synthetic", "--hidden_dims", "16", "--dropout", "0.0", "--samples_per_language",
            "16", "--batch_size", "8", "--learning_rate", "5e-3", "--warmup_steps", "2",
            "--eval_steps", "10", "--scheduler_type", "constant", "--mixed_precision", "no",
            "--no_wandb", "--device", "cpu", "--output_dir", str(out)]
    hist = train_router.main([*base, "--max_steps", "10"])
    assert len(hist["loss"]) == 10 and hist["eval"][-1]["num_samples"] > 0
    assert json.loads((out / "history.json").read_text())["eval"][-1]["step"] == 10
    hist2 = train_router.main([*base, "--max_steps", "14", "--resume_from", str(out)])
    assert len(hist2["loss"]) == 4
    cp, ccfg, meta = tclf.load_classifier(out / "classifier")
    assert meta["global_step"] == 14 and ccfg.languages == LANGS
    from sar_tpu_torch.models.base import load_base_model
    cfg, params = load_base_model("whisper-test", dtype=torch.float32)
    dirs = {}
    for i, lang in enumerate(LANGS):
        lcfg = tlora.LoraConfig(r=2, alpha=4)
        tlora.save_adapter(tmp_path / lang, tlora.init_lora(
            torch.Generator().manual_seed(i), cfg, lcfg), lcfg)
        dirs[lang] = str(tmp_path / lang)
    router = build_router_from_checkpoints(cfg, params, dirs, cp, ccfg, device="cpu")
    mel = np.stack([tds[l][0]["input_features"] for l in LANGS])[:, :, :CFG.num_audio_frames]
    names, probs = router.detect_language(router.extract_encoder_features(t(mel)))
    assert set(names) <= set(LANGS) and probs.shape == (2, 2)
    tokens = router.generate(t(mel), max_new_tokens=3)
    assert tokens.shape == (2, router.prompt_len + 3)
