"""The port's training slice against sar_tpu on whisper-test (fp32 on the
CPU, the JAX weights and numpy-made banks and data handed to both):

- forward / decode_train / cross_entropy_loss / shift_tokens_right, with
  flash off, and with the JAX package's flash on (Pallas interpret mode)
  against the port's flash path (its plain version on the CPU);
- LoRA gradients against jax.grad, with and without checkpointing;
- LoRA dropout: keep rate, 1/(1-p) scale, distinct masks per layer and
  hook, the same masks on a checkpoint recompute;
- the schedules and clipped-AdamW steps against optax;
- ASRTrainer against the JAX ASRTrainer step by step (losses, grad norms,
  final LoRA, eval_loss, predictions, WER), with checkpointing off and on;
- the selective-checkpoint policy: K6's forward runs once per layer;
- the unquantized cache and greedy tokens against JAX's defaults;
- checkpoints, callbacks, bf16 dtypes, trainable_summary, WhisperLoRA.

Tolerances are stated at each test; fp32 on both sides, they cover sums
taken in another order (1e-5 relative for one forward, 1e-4 for a few
optimizer steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_port import get_config, jax_whisper, random_bank, t, to_numpy
from jax.experimental.pallas import tpu as pltpu

from sar_tpu.data.collate import create_collator as jax_collator
from sar_tpu.data.loader import DataLoader as JaxLoader
from sar_tpu.data.synthetic import SyntheticASRDataset as JaxSynthetic
from sar_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
from sar_tpu.decode.greedy import greedy_decode as jax_greedy
from sar_tpu.models import lora as jlora
from sar_tpu.models import whisper as jw
from sar_tpu.training import ASRTrainer as JaxTrainer
from sar_tpu.training import Callback as JaxCallback
from sar_tpu.training import TrainingArgs as JaxArgs
from sar_tpu.training.optim import make_optimizer as jax_make_optimizer
from sar_tpu.training.optim import make_schedule as jax_make_schedule
from sar_tpu_torch.data import (CharTokenizer, DataLoader, SyntheticASRDataset,
                                create_collator)
from sar_tpu_torch.decode import greedy_decode
from sar_tpu_torch.models import lora as tlora
from sar_tpu_torch.models import whisper as tw
from sar_tpu_torch.ops import flash
from sar_tpu_torch.training import (ASRTrainer, Callback, CheckpointCallback,
                                    EarlyStoppingCallback, TensorBoardCallback,
                                    TrainingArgs, WandbCallback)
from sar_tpu_torch.training import optim as toptim

CFG = get_config("whisper-test")
B, T_LAB = 2, 6


@pytest.fixture(scope="module")
def world():
    """JAX and port weights (scaled so outputs depend on the input), a
    2-adapter random bank on all four targets, mel and labels."""
    jp, tp = jax_whisper(CFG, seed=0, w_scale=4.0)
    jb, tb = random_bank(CFG, 2, 4, seed=1,
                         targets=("q_proj", "k_proj", "v_proj", "out_proj"))
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((B, CFG.num_mel_bins, 64)).astype(np.float32)
    labels = rng.integers(10, 200, (B, T_LAB)).astype(np.int32)
    labels[0, -2:] = -100
    return jp, tp, jb, tb, mel, labels


def _tree_close(got, want, atol, rtol=0.0):
    got, want = to_numpy(got), to_numpy(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _tree_close(got[k], want[k], atol, rtol)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def test_shift_tokens_right_and_loss_match_jax(world):
    *_, labels = world
    want = jw.shift_tokens_right(jnp.asarray(labels), CFG.sot_token_id, CFG.pad_token_id)
    got = tw.shift_tokens_right(t(labels).long(), CFG.sot_token_id, CFG.pad_token_id)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    logits = np.random.default_rng(3).standard_normal((B, T_LAB, CFG.vocab_size)).astype(np.float32)
    np.testing.assert_allclose(
        tw.cross_entropy_loss(t(logits), t(labels).long()).item(),
        float(jw.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
    none = np.full_like(labels, -100)
    assert tw.cross_entropy_loss(t(logits), t(none).long()).item() == 0.0


# flash: JAX's Pallas kernel in interpret mode against the port's flash
# path (on the CPU its plain version); 2e-4 is sar_tpu's own tolerance
# between its flash and exact paths (tests/test_flash.py), 1e-4 without.
@pytest.mark.parametrize("flash_on,routed", [(False, False), (False, True), (True, True)])
def test_forward_matches_jax(world, flash_on, routed):
    jp, tp, jb, tb, mel, labels = world
    tok = jw.shift_tokens_right(jnp.asarray(labels), CFG.sot_token_id, CFG.pad_token_id)
    idx = np.array([1, 0], np.int32) if routed else None
    jb1 = jb if routed else jlora.slice_adapter(jb, 0)
    tb1 = tb if routed else tlora.slice_adapter(tb, 0)
    with pltpu.force_tpu_interpret_mode():
        want = jw.forward(jp, jnp.asarray(mel), tok, CFG, lora=jb1,
                          adapter_idx=None if idx is None else jnp.asarray(idx),
                          lora_scale=2.0, flash=flash_on)
    got = tw.forward(tp, t(mel), t(np.asarray(tok)).long(), CFG, lora=tb1,
                     adapter_idx=None if idx is None else t(idx),
                     lora_scale=2.0, flash=flash_on)
    assert got.dtype == torch.float32 and got.shape == (B, T_LAB, CFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-4 if flash_on else 1e-4, rtol=0)


def _jax_loss(jp, mel, labels, **kw):
    def loss(lora):
        dec_in = jw.shift_tokens_right(jnp.asarray(labels), CFG.sot_token_id, CFG.pad_token_id)
        logits = jw.forward(jp, jnp.asarray(mel), dec_in, CFG, lora=lora, lora_scale=2.0, **kw)
        return jw.cross_entropy_loss(logits, jnp.asarray(labels))
    return loss


def _port_loss(tp, mel, labels, lora, **kw):
    lab = t(labels).long()
    dec_in = tw.shift_tokens_right(lab, CFG.sot_token_id, CFG.pad_token_id)
    logits = tw.forward(tp, t(mel), dec_in, CFG, lora=lora, lora_scale=2.0, **kw)
    return tw.cross_entropy_loss(logits, lab)


def _port_grads(tp, mel, labels, bank, **kw):
    lora = tw.tree_map(lambda x: x.clone().requires_grad_(True), bank)
    loss = _port_loss(tp, mel, labels, lora, **kw)
    grads = iter(torch.autograd.grad(loss, tw.tree_leaves(lora)))
    return loss.item(), tw.tree_map(lambda _: next(grads), lora)


# LoRA gradients within 1e-5 relative to their largest entry (2e-4
# absolute with flash, as tests/test_flash.py holds JAX's own). JAX's
# interpret mode cannot checkpoint its flash kernel, so with flash only the
# port checkpoints (the result does not depend on it).
@pytest.mark.parametrize("flash_on,remat", [(False, False), (False, True), (True, True)])
def test_lora_gradients_match_jax(world, flash_on, remat):
    jp, tp, jb, tb, mel, labels = world
    jb1, tb1 = jlora.slice_adapter(jb, 0), tlora.slice_adapter(tb, 0)
    with pltpu.force_tpu_interpret_mode():
        want_loss, want = jax.value_and_grad(_jax_loss(
            jp, mel, labels, flash=flash_on, remat=remat and not flash_on))(jb1)
    loss, got = _port_grads(tp, mel, labels, tb1, flash=flash_on, remat=remat)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    scale = max(np.abs(x).max() for x in jax.tree.leaves(to_numpy(want)))
    _tree_close(_np(got), want, atol=2e-4 if flash_on else 1e-5 * scale)


def test_dropout_mask_statistics():
    """keep rate 1 - p within 1%, kept entries exactly 1/(1-p), and masks
    that differ between seeds folded with another layer or salt."""
    x = torch.ones((8, 64, 256))
    p = 0.1
    m = tw.dropout_keep(x, 123, p)
    assert abs((m != 0).float().mean().item() - (1 - p)) < 0.01
    assert torch.all((m == 0) | (m == torch.tensor(1 / (1 - p)))).item()
    torch.testing.assert_close(m, tw.dropout_keep(x, 123, p), rtol=0, atol=0)
    seeds = {(layer, salt): tw.fold_in(tw.fold_in(7, layer), salt)
             for layer in range(3) for salt in range(8)}
    assert len(set(seeds.values())) == len(seeds)
    masks = [tw.dropout_keep(x, s, p) for s in list(seeds.values())[:4]]
    for i in range(len(masks)):
        for j in range(i + 1, len(masks)):
            assert not torch.equal(masks[i], masks[j])
    enc, dec = tw.split_seed(7)
    assert enc != dec and None not in (enc, dec)


def test_dropout_masks_are_the_same_on_a_checkpoint_recompute(world, monkeypatch):
    """With dropout on, the gradients under selective or full checkpointing
    equal those without (1e-6 relative): the recompute drew the same masks.
    Every mask of the forward is one the recompute asked for again, per
    (layer, hook) seed, and each layer and hook drew its own."""
    jp, tp, jb, tb, mel, labels = world
    tb1 = tlora.slice_adapter(tb, 0)
    seen = []
    real = tw.dropout_keep

    def recording(x, seed, rate):
        seen.append(seed)
        return real(x, seed, rate)
    monkeypatch.setattr(tw, "dropout_keep", recording)
    base_loss, base = _port_grads(tp, mel, labels, tb1, lora_dropout=0.3, dropout_seed=11)
    fwd_seeds = list(seen)
    n_hooks = 4 * CFG.encoder_layers + 8 * CFG.decoder_layers
    assert len(fwd_seeds) == n_hooks == len(set(fwd_seeds))
    scale = max(np.abs(x).max() for x in tw.tree_leaves(_np(base)))
    for remat in (True, "full"):
        seen.clear()
        loss, got = _port_grads(tp, mel, labels, tb1, lora_dropout=0.3, dropout_seed=11,
                                remat=remat)
        assert loss == pytest.approx(base_loss, rel=1e-6)
        assert set(seen) == set(fwd_seeds) and len(seen) == 2 * n_hooks
        _tree_close(_np(got), _np(base), atol=1e-6 * scale)
    nodrop, _ = _port_grads(tp, mel, labels, tb1)
    other, _ = _port_grads(tp, mel, labels, tb1, lora_dropout=0.3, dropout_seed=12)
    assert nodrop != pytest.approx(base_loss, rel=1e-6)
    assert other != pytest.approx(base_loss, rel=1e-6)


def test_checkpoint_policy_saves_the_kernel_output(world, monkeypatch):
    """Through the custom-op path (each kernel wrapper taking its plain
    version on the CPU), a training forward + backward with selective
    checkpointing runs K6's forward once per attention (2 per decoder
    layer, 1 per encoder layer) and each backward kernel once per attention,
    as without checkpointing; full recompute runs the forwards twice. The
    gradients agree (1e-6 relative)."""
    jp, tp, jb, tb, mel, labels = world
    tb1 = tlora.slice_adapter(tb, 0)
    counts = {}
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        real = getattr(flash, name)

        def counted(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(flash, name, counted)
    monkeypatch.setattr(flash, "flash_mha",
                        lambda q, k, v, causal=False: flash.flash_mha_op(q, k, v, causal))
    n_attn = CFG.encoder_layers + 2 * CFG.decoder_layers
    results = {}
    for remat in (False, True, "full"):
        counts.update(dict.fromkeys(counts or ("flash_attention_fwd", "flash_attention_bwd_dkv",
                                               "flash_attention_bwd_dq"), 0))
        results[remat] = _port_grads(tp, mel, labels, tb1, flash=True, remat=remat)
        fwd = 2 * n_attn if remat == "full" else n_attn
        assert counts == {"flash_attention_fwd": fwd, "flash_attention_bwd_dkv": n_attn,
                          "flash_attention_bwd_dq": n_attn}, remat
    scale = max(np.abs(x).max() for x in tw.tree_leaves(_np(results[False][1])))
    for remat in (True, "full"):
        assert results[remat][0] == pytest.approx(results[False][0], rel=1e-6)
        _tree_close(_np(results[remat][1]), _np(results[False][1]), atol=1e-6 * scale)


@pytest.mark.parametrize("kind", ["linear", "cosine", "constant"])
def test_schedules_match_optax(kind):
    """Every count from 0 past max_steps within 1e-7 of the peak lr."""
    for warmup, max_steps in ((0, 10), (3, 20), (10, 12)):
        want = jax_make_schedule(kind, 5e-4, warmup, max_steps)
        got = toptim.make_schedule(kind, 5e-4, warmup, max_steps)
        for c in range(max_steps + 3):
            assert abs(got(c) - float(want(c))) <= 1e-7 * 5e-4, (warmup, c)


def test_clipped_adamw_steps_match_optax():
    """8 steps, gradients alternately above and below the clip norm, on a
    tree with a rank-1 leaf (no decay): parameters within 1e-7 of optax."""
    rng = np.random.default_rng(4)
    p = {"a": {"x": rng.standard_normal((3, 4, 5)).astype(np.float32)},
         "b": rng.standard_normal((6,)).astype(np.float32)}
    tx, _ = jax_make_optimizer(learning_rate=1e-2, weight_decay=0.1, warmup_steps=2,
                               max_steps=10, scheduler="linear", max_grad_norm=1.0)
    ttx, _ = toptim.make_optimizer(learning_rate=1e-2, weight_decay=0.1, warmup_steps=2,
                                   max_steps=10, scheduler="linear", max_grad_norm=1.0)
    jp = jax.tree.map(jnp.asarray, p)
    js = tx.init(jp)
    tp = tw.tree_map(torch.tensor, p)
    ts = ttx.init(tp)
    assert toptim.decay_mask(tp) == {"a": {"x": True}, "b": False}
    for i in range(8):
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * (3.0 if i % 2 else 0.05))
                         .astype(np.float32), p)
        u, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = ttx.update(tw.tree_map(torch.tensor, g), ts, tp)
        toptim.apply_updates(tp, tu)
        _tree_close(_np(tp), jp, atol=1e-7)
    assert ts["count"] == 8


class _Recorder:
    def __init__(self):
        self.logs = []

    def on_step_end(self, trainer, step, logs):
        self.logs.append((step, logs["loss"], logs["grad_norm"], logs["learning_rate"]))


class _JaxRecorder(_Recorder, JaxCallback):
    pass


class _PortRecorder(_Recorder, Callback):
    pass


def _loaders(jax_side: bool):
    Syn, coll, Loader, tok = ((JaxSynthetic, jax_collator, JaxLoader, JaxCharTokenizer)
                              if jax_side else
                              (SyntheticASRDataset, create_collator, DataLoader, CharTokenizer))
    train = Syn(CFG, size=16, num_words=2, seed=0)
    val = Syn(CFG, size=6, num_words=2, seed=99)
    c = coll(CFG.sot_token_id, pad_to_length=16)
    return (Loader(train, batch_size=4, collator=c, seed=1),
            Loader(val, batch_size=4, collator=c, shuffle=False, drop_last=False),
            tok(CFG))


# Per-step losses, grad norms and the learning rate within 1e-4 relative,
# the final bank within 1e-4 of its largest entry, eval_loss within 1e-4,
# predictions and WER equal (fp32 on both sides).
@pytest.mark.parametrize("remat", [False, True])
def test_trainer_matches_jax_trainer(remat):
    jp, tp = jax_whisper(CFG, seed=0, w_scale=2.0)
    jb, tb = random_bank(CFG, 1, 4, seed=5, std=0.02)
    kw = dict(learning_rate=3e-3, warmup_steps=1, max_steps=3, eval_steps=3,
              gradient_accumulation_steps=2, mixed_precision="no", max_new_tokens=6,
              gradient_checkpointing=remat, seed=0)
    jrec, trec = _JaxRecorder(), _PortRecorder()
    jl_train, jl_eval, jtok = _loaders(True)
    jt = JaxTrainer(CFG, jp, jb, jlora.LoraConfig(r=4, alpha=8, dropout=0.0),
                    JaxArgs(**kw), tokenizer=jtok, language="english", callbacks=[jrec])
    jh = jt.train(jl_train, jl_eval)
    tl_train, tl_eval, ttok = _loaders(False)
    tt = ASRTrainer(CFG, tp, tb, tlora.LoraConfig(r=4, alpha=8, dropout=0.0),
                    TrainingArgs(**kw, device="cpu"), tokenizer=ttok, language="english",
                    callbacks=[trec])
    th = tt.train(tl_train, tl_eval)
    assert len(trec.logs) == len(jrec.logs) == 3
    for (s1, l1, g1, lr1), (s2, l2, g2, lr2) in zip(trec.logs, jrec.logs):
        assert s1 == s2
        assert l1 == pytest.approx(l2, rel=1e-4)
        assert g1 == pytest.approx(g2, rel=1e-4)
        assert lr1 == pytest.approx(lr2, rel=1e-6)
    want = to_numpy(jt.lora)
    scale = max(np.abs(x).max() for x in jax.tree.leaves(want))
    _tree_close(_np(tt.lora), want, atol=1e-4 * scale)
    assert [e["step"] for e in th["eval"]] == [e["step"] for e in jh["eval"]] == [0, 3]
    for te, je in zip(th["eval"], jh["eval"]):
        assert te["eval_loss"] == pytest.approx(je["eval_loss"], rel=1e-4)
        assert te["wer"] == je["wer"] and te["cer"] == je["cer"]
    batch = next(iter(tl_eval.one_epoch()))
    table = torch.tensor([CFG.prompt_ids("english")])
    _, tokens = tt.eval_batch(batch, table)
    jbatch = next(iter(jl_eval.one_epoch()))
    _, jtokens = jt._eval_step(jt.lora, jt.base_params, jnp.asarray(jbatch["input_features"]),
                               jnp.asarray(jbatch["labels"]), jnp.asarray(table[0].numpy()),
                               jnp.zeros(4, jnp.int32))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))


def test_unquantized_cache_and_greedy_match_jax_defaults(world):
    """The classic unquantized cache within 1e-5 of the JAX package's
    default init_cache, and greedy tokens (with a routed bank) equal to its
    default greedy_decode."""
    jp, tp, jb, tb, mel, _ = world
    enc = jw.encode(jp, jnp.asarray(mel), CFG)
    idx = np.array([1, 0], np.int32)
    want = jw.init_cache(jp, enc, CFG, max_len=10, lora=jb, adapter_idx=jnp.asarray(idx),
                         lora_scale=2.0)
    got = tw.init_cache(tp, t(np.asarray(enc)), CFG, 10, lora=tb, adapter_idx=t(idx),
                        lora_scale=2.0, cross_kv_int8=False, self_kv_int8=False,
                        head_minor=False)
    assert got.self_k_scale is None and got.cross_k.shape == want.cross_k.shape
    for name in ("cross_k", "cross_v", "self_k"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), atol=1e-5, rtol=0)
    prompt = np.asarray(CFG.prompt_ids("english"), np.int32)
    want_tok = jax_greedy(jp, enc, CFG, jnp.asarray(prompt), max_new_tokens=12, lora=jb,
                          adapter_idx=jnp.asarray(idx), lora_scale=2.0)
    got_tok = greedy_decode(tp, t(np.asarray(enc)), CFG, prompt, max_new_tokens=12, lora=tb,
                            adapter_idx=t(idx), lora_scale=2.0, cross_kv_int8=False,
                            self_kv_int8=False)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    # self_kv_int8 alone: an int8 self cache beside the unquantized cross
    # cache, built as JAX builds it (tests/test_torch_mixed_cache.py).
    want = jw.init_cache(jp, enc, CFG, max_len=10, self_kv_int8=True)
    got = tw.init_cache(tp, t(np.asarray(enc)), CFG, 10, cross_kv_int8=False, self_kv_int8=True)
    assert got.cross_k_scale is None and want.cross_k_scale is None
    assert got.self_k.dtype == torch.int8 and got.self_k_scale.shape == want.self_k_scale.shape
    np.testing.assert_allclose(got.cross_k.numpy(), np.asarray(want.cross_k), atol=1e-5, rtol=0)
    assert not got.self_k.any() and not got.self_k_scale.any()


def _small_trainer(**kw):
    cfg_kw = dict(learning_rate=3e-3, warmup_steps=1, max_steps=2, eval_steps=0,
                  gradient_accumulation_steps=1, mixed_precision="no", max_new_tokens=4,
                  gradient_checkpointing=False, seed=0, device="cpu")
    cfg_kw.update(kw)
    _, tp = jax_whisper(CFG, seed=0)
    lcfg = tlora.LoraConfig(r=4, alpha=8, dropout=0.1)
    bank = tlora.init_lora(torch.Generator().manual_seed(3), CFG, lcfg)
    return ASRTrainer(CFG, tp, bank, lcfg, TrainingArgs(**cfg_kw),
                      tokenizer=CharTokenizer(CFG), language="english")


def test_checkpoint_round_trip(tmp_path):
    """Weights, optimizer state, step and epoch come back exactly; the
    adapter directory loads in the JAX package."""
    train, _, _ = _loaders(False)
    t1 = _small_trainer()
    t1.train(train)
    t1.best_metric = 0.25
    t1.save_checkpoint(tmp_path / "ck")
    t2 = _small_trainer()
    assert not torch.equal(tw.tree_leaves(t2.lora)[0], tw.tree_leaves(t1.lora)[0])
    t2.load_checkpoint(tmp_path / "ck")
    assert (t2.global_step, t2.epoch, t2.best_metric) == (2, t1.epoch, 0.25)
    _tree_close(_np(t2.lora), _np(t1.lora), atol=0)
    assert all(x.requires_grad and x.dtype == torch.float32 for x in tw.tree_leaves(t2.lora))
    assert t2.opt_state["count"] == t1.opt_state["count"] == 2
    for key in ("mu", "nu"):
        _tree_close(_np(t2.opt_state[key]), _np(t1.opt_state[key]), atol=0)
    jbank, jcfg, meta = jlora.load_adapter(tmp_path / "ck" / "adapter")
    _tree_close(_np(t1.lora), jbank, atol=0)
    assert jcfg.r == 4 and meta["language"] == "english"


def test_mesh_is_refused(tmp_path):
    """A mesh is taken (it was refused before the port had meshes): on a
    one-process mesh the trainer trains as without one."""
    from _torch_port import one_process_mesh
    train, _, _ = _loaders(False)
    micro = [next(iter(train.one_epoch()))]
    _, tp = jax_whisper(CFG, seed=0)
    lcfg = tlora.LoraConfig(r=4, alpha=8, dropout=0.1)

    def trainer(mesh):
        return ASRTrainer(CFG, tp, tlora.init_lora(torch.Generator().manual_seed(3), CFG,
                                                   lcfg), lcfg,
                          TrainingArgs(learning_rate=3e-3, warmup_steps=1, max_steps=2,
                                       gradient_accumulation_steps=1, mixed_precision="no",
                                       gradient_checkpointing=False, seed=0, device="cpu"),
                          mesh=mesh)
    plain = trainer(None)
    want = float(plain.train_step(micro)[0])
    with one_process_mesh(tmp_path) as mesh:
        tr = trainer(mesh)
        assert tr.mesh is mesh and tr.tp is None
        got = float(tr.train_step(micro)[0])
    assert got == pytest.approx(want, rel=1e-6)
    _tree_close(_np(tr.lora), _np(plain.lora), atol=1e-6)


def test_bf16_dtypes():
    """bf16 compute: weights bf16, LayerNorms fp32, LoRA masters fp32 (and
    lora_delta's output in the compute dtype); a step is finite and moves
    the masters."""
    tr = _small_trainer(mixed_precision="bf16", max_steps=1)
    assert tr.compute_dtype == torch.bfloat16 and not tr.flash
    assert tr.base_params["encoder"]["conv1"]["w"].dtype == torch.bfloat16
    assert tr.base_params["encoder"]["ln"]["scale"].dtype == torch.float32
    assert tr.base_params["decoder"]["layers"]["self_ln"]["scale"].dtype == torch.float32
    before = [x.detach().clone() for x in tw.tree_leaves(tr.lora)]
    assert all(x.dtype == torch.float32 for x in before)
    la, lb = tr.lora["decoder"]["self_q"]["a"][0], tr.lora["decoder"]["self_q"]["b"][0]
    x = torch.randn(2, 3, CFG.d_model).to(torch.bfloat16)
    assert tw.lora_delta(x, la, lb, tw.LoraCtx()).dtype == torch.bfloat16
    train, _, _ = _loaders(False)
    hist = tr.train(train)
    assert np.isfinite(hist["loss"]).all()
    after = tw.tree_leaves(tr.lora)
    assert all(a.dtype == torch.float32 for a in after)
    assert any(not torch.equal(a.detach(), b) for a, b in zip(after, before))


def test_flash_attention_resolution():
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert not TrainingArgs().resolve_flash(cpu)
    assert TrainingArgs().resolve_flash(cuda)
    # The dtype does not turn the kernel off: an fp32 run on the card reaches
    # the wrapper's bf16 check and raises there.
    assert TrainingArgs(mixed_precision="no").resolve_flash(cuda)
    assert TrainingArgs(flash_attention="on").resolve_flash(cpu)
    assert not TrainingArgs(flash_attention="off").resolve_flash(cuda)


def test_trainable_summary_matches_jax(world):
    jp, tp, jb, tb, *_ = world
    want = jlora.trainable_summary(jb, jp)
    assert tlora.trainable_summary(tb, tp) == want
    assert tlora.trainable_summary(tb, tw.cast_params(tp, torch.bfloat16)) == want


def test_early_stopping_fires():
    cb = EarlyStoppingCallback(patience=2, min_delta=0.01)

    class T:
        global_step = 0
    cb.on_evaluate_end(T, {"wer": 1.0})
    cb.on_evaluate_end(T, {"wer": 1.0})
    assert not cb.should_stop
    cb.on_evaluate_end(T, {"wer": 1.0})
    assert cb.should_stop


def test_checkpoint_callback_rolling_limit(tmp_path):
    class FakeTrainer:
        best_metric = None
        global_step = 0

        def save_checkpoint(self, path):
            path.mkdir(parents=True, exist_ok=True)
            (path / "marker").write_text("x")

    tr = FakeTrainer()
    cb = CheckpointCallback(tmp_path, save_steps=1, save_total_limit=2)
    for step in (1, 2, 3, 4):
        cb.on_step_end(tr, step, {})
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_3", "step_4"]
    cb.on_evaluate_end(tr, {"wer": 0.5})
    cb.on_evaluate_end(tr, {"wer": 0.9})
    assert (tmp_path / "best" / "marker").exists()
    assert cb.best_value == 0.5 and tr.best_metric == 0.5


def test_wandb_tensorboard_noop(tmp_path, monkeypatch):
    import builtins

    class T:
        global_step = 1
    w = WandbCallback()
    w.on_train_begin(T)
    w.on_step_end(T, 1, {"loss": 1.0})
    w.on_evaluate_end(T, {"wer": 1.0})
    w.on_train_end(T)
    real_import = builtins.__import__

    def broken(name, *a, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError(name)
        return real_import(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", broken)
    tb = TensorBoardCallback(tmp_path / "tb")
    tb.on_train_begin(T)
    assert tb._writer is None
    tb.on_step_end(T, 1, {"loss": 1.0})
    tb.on_train_end(T)


def test_whisper_lora_handle(tmp_path):
    """forward equals whisper.forward's loss; generate / transcribe run;
    save_adapter + load_whisper_lora_from_checkpoint restore the bank."""
    from sar_tpu_torch.models.whisper_lora import (create_whisper_lora,
                                                   load_whisper_lora_from_checkpoint)
    m = create_whisper_lora("whisper-test", language="english", lora_rank=4,
                            lora_alpha=8, dtype=torch.float32, device="cpu")
    ds = SyntheticASRDataset(CFG, size=2, num_words=2, seed=0)
    batch = create_collator(CFG.sot_token_id, pad_to_length=12)([ds[0], ds[1]])
    out = m.forward(batch["input_features"], batch["labels"])
    assert out["logits"].shape == (2, 12, CFG.vocab_size) and torch.isfinite(out["loss"])
    texts = m.transcribe(batch["input_features"], max_new_tokens=4)
    assert len(texts) == 2 and all(isinstance(x, str) for x in texts)
    assert m.generate(batch["input_features"], max_new_tokens=4, num_beams=2).shape[0] == 2
    m.save_adapter(tmp_path / "ad")
    m2 = load_whisper_lora_from_checkpoint(tmp_path / "ad", "whisper-test",
                                           dtype=torch.float32, device="cpu")
    assert m2.language == "english"
    _tree_close(_np(m2.lora), _np(m.lora), atol=0)
    merged = m.merge_and_unload()
    assert merged["decoder"]["layers"]["self_q"]["w"].shape == (
        CFG.decoder_layers, CFG.d_model, CFG.d_model)
