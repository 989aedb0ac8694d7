"""sar_tpu_torch/parallel against the JAX package's single-device results.

The unit cases run in this process: mesh shapes and their messages, the
layout tree, the process-group start-up read from the environment, batch
row ranges. The parity cases read one spawned world of four gloo ranks
(tests/_torch_parallel_worker.py), which builds a data 2 x model 2 mesh, a
replica 2 x data 1 x model 2 mesh and the data 4 and model 4 ones, and
runs the port's forward, LoRA gradients, greedy decode, ASRTrainer,
ASREvaluator and LIDTrainer on them; each test compares one result with
the JAX package's single-device function on the same seeded weights (the
oracles of tests/test_sharding.py and tests/test_distributed.py), at
JAX's atol of 2e-4 in fp32 and greedy ids exactly. One case runs an odd
vocabulary (257 rows over four ranks) in both packages.
"""

from __future__ import annotations

import dataclasses
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper, random_bank, t, to_numpy

from sar_tpu.data.collate import LIDCollator as JaxLIDCollator
from sar_tpu.data.collate import create_collator as jax_collator
from sar_tpu.data.loader import DataLoader as JaxLoader
from sar_tpu.data.synthetic import SyntheticASRDataset as JaxSynthetic
from sar_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
from sar_tpu.decode import greedy_decode as jax_greedy
from sar_tpu.evaluation.evaluator import ASREvaluator as JaxEvaluator
from sar_tpu.models import classifier as jclf
from sar_tpu.models import lora as jlora
from sar_tpu.models import whisper as jw
from sar_tpu.training import ASRTrainer as JaxTrainer
from sar_tpu.training import TrainingArgs as JaxArgs
from sar_tpu.training import lid_trainer as jlid
from sar_tpu_torch.models import classifier as tclf
from sar_tpu_torch.models import lora as tlora
from sar_tpu_torch.models import whisper as tw
from sar_tpu_torch.models.convert import from_jax_params
from sar_tpu_torch.parallel import distributed as pdist
from sar_tpu_torch.parallel import sharding

CFG = get_config("whisper-test")
CFG257 = dataclasses.replace(CFG, vocab_size=257)
LANGS = ["english", "german"]
ATOL = 2e-4
WORLD = 4
JOIN_S = 180


def _tree_close(got: dict, want: dict) -> None:
    """Two nested dicts of arrays with the same keys, leaf by leaf at ATOL."""
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], dict):
            _tree_close(got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=ATOL, rtol=0,
                                       err_msg=k)


@pytest.fixture(scope="module")
def inputs():
    """The seeded inputs of both sides: JAX weights (scaled so the tiny
    model's outputs depend on its input), the same as port params, and
    numpy data. Rows 0-2 of the labels end in -100, so the data shards
    hold different numbers of label tokens."""
    jp, tp = jax_whisper(CFG, seed=0, w_scale=2.0)
    jp257, tp257 = jax_whisper(CFG257, seed=1, w_scale=2.0)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((8, CFG.num_mel_bins, 64)).astype(np.float32)
    tokens = rng.integers(0, CFG.vocab_size, (8, 6)).astype(np.int64)
    labels = rng.integers(10, 200, (8, 6)).astype(np.int64)
    labels[:3, 3:] = -100
    jb, tb = random_bank(CFG, 1, 4, seed=5, std=0.05,
                         targets=("q_proj", "v_proj", "out_proj"))
    jtb, ttb = random_bank(CFG, 1, 4, seed=5, std=0.02)
    eval_mel = rng.standard_normal((6, CFG.num_mel_bins, 64)).astype(np.float32)
    jccfg = jclf.ClassifierConfig(input_dim=CFG.d_model, hidden_dims=(32,),
                                  num_classes=2, dropout=0.0, languages=LANGS)
    jcp = jclf.init_classifier(jax.random.PRNGKey(5), jccfg)
    return dict(jp=jp, tp=tp, jp257=jp257, tp257=tp257, mel=mel, tokens=tokens,
                labels=labels, jb=jb, tb=tb, jtb=jtb, ttb=ttb, eval_mel=eval_mel,
                jccfg=jccfg, jcp=jcp)


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """The four ranks, started once for the module; the parent computes the
    JAX references (`ref`) while they run."""
    import _torch_parallel_worker as worker

    d = tmp_path_factory.mktemp("parallel")
    data = {"params": inputs["tp"], "params257": inputs["tp257"],
            "mel": t(inputs["mel"]), "tokens": t(inputs["tokens"]),
            "labels": t(inputs["labels"]), "bank": inputs["tb"],
            "tparams": inputs["tp"], "tbank": inputs["ttb"],
            "eval_mel": t(inputs["eval_mel"]),
            "clf_params": from_jax_params(to_numpy(inputs["jcp"])),
            "ccfg": tclf.ClassifierConfig.from_dict(inputs["jccfg"].to_dict())}
    torch.save(data, d / "data.pt")
    ctx = torch.multiprocessing.start_processes(
        worker.run, args=(WORLD, str(d)), nprocs=WORLD, join=False,
        start_method="spawn")
    yield ctx, d, time.monotonic() + JOIN_S
    for p in ctx.processes:
        if p.is_alive():
            p.kill()


@pytest.fixture(scope="module")
def ranks(world, ref):
    """The four ranks' results."""
    ctx, d, deadline = world
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            pytest.fail(f"the {WORLD} spawned ranks did not finish in {JOIN_S} s")
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def ref(inputs, world):
    """The JAX package's single-device results, once per module, computed
    while the spawned ranks run."""
    jp, mel = inputs["jp"], jnp.asarray(inputs["mel"])
    prompt = jnp.asarray(CFG.prompt_ids("english"), jnp.int32)
    labels = jnp.asarray(inputs["labels"], jnp.int32)

    def loss_fn(lora):
        dec_in = jw.shift_tokens_right(labels, CFG.sot_token_id, CFG.pad_token_id)
        logits = jw.forward(jp, mel, dec_in, CFG, lora=lora, lora_scale=2.0)
        return jw.cross_entropy_loss(logits, labels)

    # Jitted: a third of the time of JAX's op-by-op dispatch here.
    tokens = jnp.asarray(inputs["tokens"], jnp.int32)
    out = {"fwd": np.asarray(jax.jit(lambda p: jw.forward(p, mel, tokens, CFG))(jp)),
           "grad": to_numpy(jax.jit(jax.grad(loss_fn))(inputs["jb"])),
           "greedy": np.asarray(jax_greedy(jp, jw.encode(jp, mel, CFG), CFG, prompt,
                                           max_new_tokens=8))}
    jp257 = inputs["jp257"]
    out["fwd_v257"] = np.asarray(jax.jit(lambda p: jw.forward(p, mel, tokens, CFG257))(
        jp257))
    # Greedy over the odd vocabulary against the port on one process (whose
    # greedy ids equal JAX's: tests/test_torch_decode_defaults.py), to save
    # a JAX compile.
    from sar_tpu_torch.decode.greedy import greedy_decode
    from sar_tpu_torch.models.config import get_config as port_config
    cfg257 = dataclasses.replace(port_config("whisper-test"), vocab_size=257)
    tp257, tmel = inputs["tp257"], t(inputs["mel"])
    out["greedy_v257"] = greedy_decode(tp257, tw.encode(tp257, tmel, cfg257), cfg257,
                                       CFG.prompt_ids("english"), max_new_tokens=8).numpy()
    # ASRTrainer (tests/test_sharding.py's setup, with an evaluation).
    coll = jax_collator(CFG.sot_token_id, pad_to_length=16)
    tr = JaxTrainer(CFG, jp, inputs["jtb"], jlora.LoraConfig(r=4, alpha=8, dropout=0.0),
                    JaxArgs(learning_rate=3e-3, warmup_steps=1, max_steps=3, eval_steps=3,
                            gradient_accumulation_steps=2, mixed_precision="no",
                            gradient_checkpointing=False, max_new_tokens=6, seed=0),
                    tokenizer=JaxCharTokenizer(CFG), language="english")
    hist = tr.train(JaxLoader(JaxSynthetic(CFG, size=16, num_words=2, seed=5), 4, coll,
                              seed=7),
                    JaxLoader(JaxSynthetic(CFG, size=6, num_words=2, seed=99), 4, coll,
                              shuffle=False, drop_last=False))
    out["trainer"] = {"loss": np.array(hist["loss"]), "eval": hist["eval"],
                      "bank": to_numpy(tr.lora)}
    tok = JaxCharTokenizer(CFG)
    emel = jnp.asarray(inputs["eval_mel"])
    out["eval_plain"] = JaxEvaluator(CFG, jp, tok, language="english", max_new_tokens=8,
                                     kv_int8=False)._transcribe_batch(emel)
    out["eval_int8"] = JaxEvaluator(CFG, jp, tok, language="english",
                                    max_new_tokens=8)._transcribe_batch(emel)
    # LIDTrainer (tests/test_sharding.py's setup).
    ds = jlid.LIDDataset({l: JaxSynthetic(CFG, size=12, language=l, language_id=i, seed=i)
                          for i, l in enumerate(LANGS)}, LANGS)
    lid = jlid.LIDTrainer(CFG, jp, inputs["jcp"], inputs["jccfg"], jlid.LIDTrainingArgs(
        learning_rate=5e-3, weight_decay=0.0, warmup_steps=2, max_steps=4, eval_steps=4,
        scheduler="constant", mixed_precision="no", gradient_accumulation_steps=2))
    h = lid.train(JaxLoader(ds, 4, JaxLIDCollator(), seed=3),
                  JaxLoader(ds, 9, JaxLIDCollator(), shuffle=False, drop_last=False))
    out["lid"] = {"loss": np.array(h["loss"]), "eval": h["eval"][-1]}
    jax.clear_caches()
    return out


# ---------------------------------------------------------------------------
# In-process unit cases
# ---------------------------------------------------------------------------

def _devs(n, per_slice=None):
    return [pdist.RankDevice(i, i // per_slice if per_slice else 0) for i in range(n)]


def test_mesh_shapes_and_messages():
    with pytest.raises(ValueError, match=r"mesh 3x1 != 4 devices"):
        sharding.make_mesh(3, 1, devices=_devs(4))
    assert pdist.multislice_layout(dp=2, tp=2, devices_=_devs(8))[:3] == (2, 2, 2)
    with pytest.raises(ValueError, match="needs 16 devices but only 8"):
        pdist.multislice_layout(dp=8, tp=2, replicas=1, devices_=_devs(8))
    # Two nodes of 4: "replica" strides across them, each node contiguous.
    _, _, _, devs = pdist.multislice_layout(dp=1, tp=2, replicas=2,
                                            devices_=_devs(8, per_slice=4)[::-1])
    assert [d.id for d in devs] == [0, 1, 4, 5]
    assert pdist.num_slices(_devs(8, per_slice=4)) == 2
    with pytest.raises(ValueError, match="multiple of the slice count"):
        pdist.multislice_layout(dp=1, tp=1, replicas=1, devices_=_devs(4, per_slice=2))
    uneven = _devs(4, per_slice=4) + [pdist.RankDevice(4, 1)]
    with pytest.raises(ValueError, match=r"slices \[1\] have only \{1: 1\}"):
        pdist.multislice_layout(dp=1, tp=2, replicas=2, devices_=uneven)


def test_mesh_from_flags_under_one_process():
    assert sharding.mesh_from_flags(1, 1) is None
    assert sharding.mesh_from_flags(1, 1, dcn_dp=1) is None
    with pytest.raises(SystemExit, match=r"--tp 2 needs 2 devices.*torchrun "
                                         r"--nproc_per_node 2"):
        sharding.mesh_from_flags(1, 2)
    with pytest.raises(SystemExit, match="needs 8 devices"):
        sharding.mesh_from_flags(2, 2, dcn_dp=2)


def test_param_specs_tree_has_the_params_structure():
    _, tp = jax_whisper(CFG, seed=0)
    for params in (tp, tw.cast_params(tp, torch.bfloat16)):
        specs = sharding.param_specs(params)

        def same(a, b):
            assert isinstance(a, dict) == isinstance(b, dict)
            if isinstance(a, dict):
                assert a.keys() == b.keys()
                for k in a:
                    same(a[k], b[k])
        same(params, specs)
        # Every split dim exists.
        sharding._tree_map(lambda x, s: s is None or s < x.dim() or pytest.fail(s),
                           params, specs)
    assert sharding.lora_specs({"encoder": {"q": {"a": torch.zeros(1)}}}) == {
        "encoder": {"q": {"a": None}}}


def test_split_range_deals_as_tensor_split():
    for n, size in ((257, 4), (51865, 2), (64, 4), (7, 3)):
        got = [sharding.split_range(n, sharding.ModelGroup(None, r, size))
               for r in range(size)]
        want, lo = [], 0
        for c in torch.tensor_split(torch.arange(n), size):
            want.append((lo, lo + len(c)))
            lo += len(c)
        assert got == want


def _clear_env(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "SLURM_NTASKS",
              "WORLD_SIZE", "RANK", "MASTER_ADDR", "LOCAL_RANK", "SLURM_PROCID"):
        monkeypatch.delenv(k, raising=False)


def test_initialize_is_a_noop_for_one_process(monkeypatch):
    _clear_env(monkeypatch)
    assert pdist.maybe_initialize_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert pdist.maybe_initialize_distributed() is False
    assert pdist.world_size() == 1 and pdist.rank() == 0 and pdist.is_main_process()


def test_initialize_reads_the_environment(monkeypatch):
    """JAX's coordinator variables, torchrun's and SLURM's each start the
    group (recorded, not started), gloo without CUDA."""
    calls = []
    monkeypatch.setattr(pdist.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(pdist.dist, "get_rank", lambda: 0)
    monkeypatch.setattr(pdist.dist, "get_world_size", lambda: 2)
    _clear_env(monkeypatch)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    assert pdist.maybe_initialize_distributed() is True
    _clear_env(monkeypatch)
    for k, v in (("WORLD_SIZE", "4"), ("RANK", "3"), ("MASTER_ADDR", "h"),
                 ("LOCAL_RANK", "3")):
        monkeypatch.setenv(k, v)
    assert pdist.maybe_initialize_distributed() is True
    _clear_env(monkeypatch)
    for k, v in (("SLURM_NTASKS", "2"), ("SLURM_PROCID", "1"), ("MASTER_ADDR", "n0")):
        monkeypatch.setenv(k, v)
    assert pdist.maybe_initialize_distributed() is True
    assert calls == [
        ("gloo", dict(init_method="tcp://10.0.0.1:1234", world_size=2, rank=1)),
        ("gloo", dict(init_method="env://", world_size=4, rank=3)),
        ("gloo", dict(init_method="tcp://n0:29500", world_size=2, rank=1))]
    _clear_env(monkeypatch)
    with pytest.raises(ValueError, match="num_processes"):
        pdist.maybe_initialize_distributed("h:1")


def test_batch_rows_of_a_mesh():
    """put_global_batch keeps this rank's rows; local_batch_size splits a
    batch over the batch shards with JAX's divisibility error."""
    mesh = types.SimpleNamespace(
        mesh_dim_names=("replica", "data", "model"), mesh=torch.zeros(2, 2, 2),
        device_type="cpu", get_coordinate=lambda: [1, 1, 0], get_group=lambda name: None)
    assert pdist.batch_axis_names(mesh) == ("replica", "data")
    assert pdist.n_batch_shards(mesh) == 4
    assert pdist.axis_sizes(mesh) == {"replica": 2, "data": 2, "model": 2}
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    np.testing.assert_array_equal(pdist.put_global_batch(x, mesh).numpy(), x[6:])
    np.testing.assert_array_equal(pdist.put_global_batch(x.T.copy(), mesh, 1).numpy(),
                                  x.T[:, 6:])
    assert sharding.batch_sharding(mesh) == (3, 4)
    assert pdist.local_batch_size(32) == 32 and pdist.local_batch_size(32, mesh) == 8
    with pytest.raises(ValueError, match="not divisible"):
        pdist.local_batch_size(6, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        pdist.put_global_batch(x[:6], mesh)


def test_eval_padding_takes_tensors_and_arrays():
    """A partial eval batch padded to the batch shards (ASRTrainer's and
    LIDTrainer's evaluations): features as an array or as a tensor (the
    raw-audio collator's, on its device) alike, zero rows and -100 labels
    appended; nothing appended without a mesh."""
    from sar_tpu_torch.training.trainer import _pad_rows
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), mesh=torch.zeros(4, 2))
    feats = np.random.default_rng(0).standard_normal((6, 3, 5)).astype(np.float32)
    labels = np.arange(12).reshape(6, 2)
    for f in (feats, torch.from_numpy(feats)):
        out = _pad_rows({"input_features": f, "labels": labels, "texts": ["a"] * 6}, mesh)
        assert isinstance(out["input_features"], torch.Tensor)
        np.testing.assert_array_equal(out["input_features"].numpy(),
                                      np.concatenate([feats, np.zeros((2, 3, 5))]))
        np.testing.assert_array_equal(out["labels"].numpy()[6:], -100)
        np.testing.assert_array_equal(out["language_ids"].numpy(), np.zeros(8))
        assert out["texts"] == ["a"] * 6
        assert _pad_rows({"input_features": f, "labels": labels}, None)[
            "input_features"].shape == (6, 3, 5)


def test_shard_params_refuses_to_split_a_head():
    mesh = types.SimpleNamespace(
        mesh_dim_names=("data", "model"), mesh=torch.zeros(1, 3), device_type="cpu",
        get_coordinate=lambda: [0, 0], get_group=lambda name: None)
    with pytest.raises(ValueError, match="cannot split whisper-test's 4 encoder heads"):
        sharding.shard_params({}, mesh, get_config("whisper-test"))


# ---------------------------------------------------------------------------
# Parity at world size 4
# ---------------------------------------------------------------------------

def test_meshes_of_the_spawned_world(ranks):
    r0 = ranks[0]
    assert r0["axes"] == {"d4m1": {"data": 4, "model": 1}, "d2m2": {"data": 2, "model": 2},
                          "d1m4": {"data": 1, "model": 4},
                          "r2d1m2": {"replica": 2, "data": 1, "model": 2}}
    assert r0["batch_shards"] == {"d4m1": 4, "d2m2": 2, "d1m4": 1, "r2d1m2": 2}
    # Rank r holds rows by its place on the batch axes.
    assert [r["rows"]["d4m1"] for r in ranks] == [(0, 1), (2, 3), (4, 5), (6, 7)]
    assert [r["rows"]["d2m2"] for r in ranks] == [(0, 1, 2, 3)] * 2 + [(4, 5, 6, 7)] * 2
    assert [r["rows"]["d1m4"] for r in ranks] == [tuple(range(8))] * 4


@pytest.mark.parametrize("mesh", ["d4m1", "d2m2", "d1m4", "r2d1m2", "d2m2_hm",
                                  "d2m2_k6"])
def test_forward_matches_jax(ranks, ref, mesh):
    """Exact attention on every mesh; on d2m2 also the encoder through K1's
    and K6's routes (their plain versions on the CPU) on local heads."""
    for r in ranks:
        np.testing.assert_allclose(r[f"fwd_{mesh}"], ref["fwd"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["d2m2", "d2m2_remat", "r2d1m2"])
def test_lora_gradient_matches_jax(ranks, ref, case):
    """q/v (column parallel) and o (row parallel) adapters; the loss is the
    global mean over shards with unequal label counts."""
    for r in ranks:
        _tree_close(r[f"grad_{case}"], ref["grad"])


@pytest.mark.parametrize("mesh", ["d2m2", "r2d1m2"])
def test_greedy_ids_equal_jax(ranks, ref, mesh):
    for r in ranks:
        np.testing.assert_array_equal(r[f"greedy_{mesh}"], ref["greedy"])


def test_odd_vocabulary(ranks, ref):
    """V = 257 over four "model" ranks: 65/64/64/64 embedding rows, the
    logits gathered to 257 (the forward equal to JAX's) and greedy equal
    to one process's."""
    assert [r["v257_rows"] for r in ranks] == [65, 64, 64, 64]
    for r in ranks:
        assert r["fwd_v257"].shape[-1] == 257
        np.testing.assert_allclose(r["fwd_v257"], ref["fwd_v257"], atol=ATOL, rtol=0)
        np.testing.assert_array_equal(r["greedy_v257"], ref["greedy_v257"])


@pytest.mark.parametrize("mesh", ["d2m2", "r2d1m2", "flash_d2m2"])
def test_trainer_matches_jax(ranks, ref, mesh):
    """ASRTrainer(mesh=) with accumulation 2: the loss trajectory and the
    bank of the JAX trainer on one device; with an evaluation (a partial
    batch) on d2m2, its eval loss and WER; with flash_attention="on"
    (K6's route, its plain version on the CPU) over local heads."""
    want = ref["trainer"]
    for r in ranks:
        got = r[f"trainer_{mesh}"]
        np.testing.assert_allclose(got["loss"], want["loss"], atol=ATOL, rtol=0)
        _tree_close(got["bank"], want["bank"])
        for ge, we in zip(got["eval"], want["eval"]):
            assert ge["step"] == we["step"] and ge["num_samples"] == we["num_samples"]
            assert ge["eval_loss"] == pytest.approx(we["eval_loss"], abs=ATOL)
            assert ge["wer"] == we["wer"] and ge["cer"] == we["cer"]
    assert len(ranks[0]["trainer_d2m2"]["eval"]) == 2


def test_trainer_with_dropout_matches_one_process(ranks, inputs):
    """LoRA dropout 0.1 under checkpointing: the masks are the global
    batch's at each rank's rows, so the mesh trains as one process does."""
    import _torch_parallel_worker as worker
    want = worker._trainer_run(CFG, inputs["tp"], inputs["ttb"], None, dropout=0.1,
                               remat=True, max_steps=2)
    for r in ranks:
        got = r["trainer_dropout_d2m2"]
        np.testing.assert_allclose(got["loss"], want["loss"], atol=ATOL, rtol=0)
        _tree_close(got["bank"], want["bank"])
    # Dropout moved the trajectory off the undropped one.
    assert not np.allclose(want["loss"], ranks[0]["trainer_d2m2"]["loss"][:2], atol=1e-6)


@pytest.mark.parametrize("mesh,want", [("d4m1", "eval_plain"), ("d2m2", "eval_int8"),
                                       ("r2d1m2", "eval_int8")])
def test_evaluator_texts_match_jax(ranks, ref, mesh, want):
    """ASREvaluator(mesh=) on 6 rows (padded to 8 over four data shards on
    d4m1) over the unquantized or the classic int8 cache of this rank's
    heads: the texts of the JAX evaluator on one device, on every rank."""
    heads = CFG.decoder_heads // ranks[0]["axes"][mesh]["model"]
    for r in ranks:
        assert r[f"eval_{mesh}"] == ref[want]
        assert r[f"eval_cache_{mesh}"][2] == heads
    assert len(ref[want]) == 6 and len(set(ref[want])) > 1


def test_lid_trainer_matches_jax(ranks, ref):
    want = ref["lid"]
    for r in ranks:
        got = r["lid_d2m2"]
        np.testing.assert_allclose(got["loss"], want["loss"], atol=ATOL, rtol=0)
        assert got["eval"]["accuracy"] == want["eval"]["accuracy"]
        assert got["eval"]["confusion_matrix"] == want["eval"]["confusion_matrix"]
        assert got["eval"]["num_samples"] == want["eval"]["num_samples"] == 24
