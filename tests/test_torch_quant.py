"""The port's opt-in quantized decode against sar_tpu on the CPU (fp32,
whisper-test with the JAX weights bridged over, scaled x5 so that tokens
depend on the input): int4 packing bit for bit over every nibble pair and
every byte; `_attention_int8_mxu`, `_attention_int4` and the s8
cross-attention within 2e-5; `decode_step` logits under `scores_int8` and
over the int4 cache within 1e-4 over 4 steps (greedy and beam-folded);
greedy and beam tokens EXACTLY equal to JAX's (beam against JAX
`beam_decode(head_minor=True, scores_int8=True)`, whose CPU default layout
is the classic one); the evaluator's predictions and WER/CER equal to the
JAX evaluator's with `scores_int8` and with `kv_int4`; the service, the
evaluate CLI's flags and scripts/s8_gate.py with `--device cpu`."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper, t

from sar_tpu.decode.beam import beam_decode as jax_beam
from sar_tpu.decode.greedy import greedy_decode as jax_greedy
from sar_tpu.evaluation.evaluator import ASREvaluator as JaxEvaluator
from sar_tpu.models import whisper as jw
from sar_tpu_torch.decode import beam_decode, greedy_decode
from sar_tpu_torch.evaluation import ASREvaluator
from sar_tpu_torch.models import whisper as tw

CFG = get_config("whisper-test")
B = 3
H, hd = CFG.decoder_heads, CFG.d_model // CFG.decoder_heads
PROMPT = CFG.prompt_ids("english")
NEW = 12
S8 = dict(cross_kv_int8=True, self_kv_int8=True, scores_int8=True)
INT4 = dict(cross_kv_int4=True, self_kv_int4=True)


@pytest.fixture(scope="module")
def model():
    jp, tp = jax_whisper(CFG, seed=0, w_scale=5.0)
    mel = np.random.default_rng(7).standard_normal(
        (B, CFG.num_mel_bins, CFG.num_audio_frames)).astype(np.float32)
    return jp, tp, jw.encode(jp, jnp.asarray(mel), CFG)


# --- int4 packing --------------------------------------------------------

def test_int4_pack_and_unpack_every_nibble_pair_bit_for_bit():
    """Rows [a, 7, b, 0] (scale 1, so the lanes are exactly a and b): byte 0
    packs low lane a with high lane b, for all 15 x 15 pairs."""
    a, b = np.meshgrid(np.arange(-7, 8), np.arange(-7, 8), indexing="ij")
    x = np.stack([a.ravel(), np.full(225, 7), b.ravel(), np.zeros(225)], -1).astype(np.float32)
    got, gs = tw.quantize_kv4(t(x))
    want, ws = jw.quantize_kv4(jnp.asarray(x))
    assert got.dtype == torch.int8 and got.shape == (225, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    lo, hi = tw.unpack_kv4(got)
    np.testing.assert_array_equal(lo[:, 0].numpy(), a.ravel())
    np.testing.assert_array_equal(hi[:, 0].numpy(), b.ravel())


def test_int4_unpack_every_byte_and_random_rows_bit_for_bit():
    byte = np.arange(-128, 128, dtype=np.int8)
    for g, w in zip(tw.unpack_kv4(t(byte)), jw.unpack_kv4(jnp.asarray(byte))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x = np.random.default_rng(2).standard_normal((2, 3, 9, hd)).astype(np.float32)
    x[0, 0, 0] = 0.0                                     # an all-zero row
    got, gs = tw.quantize_kv4(t(x))
    want, ws = jw.quantize_kv4(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    with pytest.raises(ValueError, match="even"):
        tw.quantize_kv4(torch.zeros(2, 3))


# --- attention functions ---------------------------------------------------

def _self_data(int4, seed=3, T=9, Q=1):
    rng = np.random.default_rng(seed)
    quant = jw.quantize_kv4 if int4 else jw.quantize_kv
    q = rng.standard_normal((2, H, Q, hd)).astype(np.float32) * hd ** -0.5
    kq, ks = quant(jnp.asarray(rng.standard_normal((2, H, T, hd)), jnp.float32))
    vq, vs = quant(jnp.asarray(rng.standard_normal((2, H, T, hd)), jnp.float32))
    mask = (np.arange(T) <= 5)[None, None, None, :]
    return [np.asarray(x) for x in (q, kq, ks, vq, vs, mask)]


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("fn", ["_attention_int8_mxu", "_attention_int4"])
def test_quantized_attention_matches_jax(fn, masked):
    q, kq, ks, vq, vs, mask = _self_data(int4=fn == "_attention_int4", Q=1 if masked else 3)
    m = mask if masked else None
    want = getattr(jw, fn)(*(jnp.asarray(x) for x in (q, kq, ks, vq, vs)),
                           mask=None if m is None else jnp.asarray(m))
    got = getattr(tw, fn)(*(t(x) for x in (q, kq, ks, vq, vs)),
                          mask=None if m is None else t(m))
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("K", [1, 3])
def test_s8_cross_attention_matches_jax(K):
    """The port's `_cross_attention_int8_mxu` (quantize q per (row, head),
    fold K beams, K7's plain version over the stacked slabs) against JAX's
    jnp twin on one layer's slabs (q folded [B/K, H, K, hd])."""
    rng = np.random.default_rng(5 + K)
    Ls, Bs, S_pad, S = 2, 2, 128, 32
    kq, ks = jw.quantize_kv(jnp.asarray(rng.standard_normal((Ls, Bs, S_pad, H, hd)), jnp.float32))
    vq, vs = jw.quantize_kv(jnp.asarray(rng.standard_normal((Ls, Bs, S_pad, H, hd)), jnp.float32))
    ks = ks.transpose(0, 1, 3, 2).at[..., S:].set(0.0)
    vs = vs.transpose(0, 1, 3, 2).at[..., S:].set(0.0)
    kq, vq = kq.reshape(Ls, Bs, S_pad, H * hd), vq.reshape(Ls, Bs, S_pad, H * hd)
    q = rng.standard_normal((Bs * K, 1, H * hd)).astype(np.float32) * hd ** -0.5
    qh = jnp.asarray(q[:, 0].reshape(Bs, K, H, hd).transpose(0, 2, 1, 3))
    for layer in range(Ls):
        want = jw._cross_attention_int8_mxu(qh, kq[layer], ks[layer], vq[layer], vs[layer])
        want = np.asarray(want).transpose(0, 2, 1, 3).reshape(Bs * K, 1, H * hd)
        got = tw._cross_attention_int8_mxu(t(q), t(kq), t(ks), t(vq), t(vs), layer=layer,
                                           n_heads=H, beam_width=K)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# --- decode_step -----------------------------------------------------------

@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("mode", ["s8", "int4"])
def test_decode_step_logits_match_jax(model, mode, K):
    """Both sides step over the JAX-built cache (bridged), so the step alone
    is compared; K=2 folds the beams, with the physical-reorder self cache
    (no ancestry) as both packages take it here."""
    jp, tp, enc = model
    kw = dict(cross_kv_int8=True, self_kv_int8=True, head_minor=True) if mode == "s8" else INT4
    jc = jw.init_cache(jp, enc, CFG, max_len=10, self_batch=B * K, **kw)
    tc = tw.DecodeCache(*(None if x is None else t(x) for x in jc))
    if mode == "int4":
        assert tc.cross_k.shape[-1] == tc.self_k.shape[-1] == hd // 2
    rng = np.random.default_rng(11)
    for pos in range(4):
        toks = rng.integers(0, CFG.vocab_size, size=B * K)
        lj, jc = jw.decode_step(jp, jnp.asarray(toks, jnp.int32), jnp.int32(pos), jc, CFG,
                                scores_int8=mode == "s8", beam_width=K)
        lt, tc = tw.decode_step(tp, torch.from_numpy(toks), pos, tc, CFG,
                                scores_int8=mode == "s8", beam_width=K)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tc.self_k.numpy(), np.asarray(jc.self_k))


def test_init_cache_int4_matches_jax_and_decode_step_refusals(model):
    jp, tp, enc = model
    want = jw.init_cache(jp, enc, CFG, max_len=8, self_batch=2 * B, **INT4)
    got = tw.init_cache(tp, t(enc), CFG, max_len=8, self_batch=2 * B, **INT4)
    for name, a in got._asdict().items():
        b = np.asarray(getattr(want, name))
        assert tuple(a.shape) == b.shape and str(a.dtype).split(".")[-1] == str(b.dtype)
        if a.dtype == torch.int8:       # one flip at a .5 boundary is within the rules
            assert (a.numpy() != b).mean() <= 1e-3
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)
    tok = torch.zeros(B, dtype=torch.long)
    int8_cache = tw.init_cache(tp, t(enc), CFG, max_len=8, cross_kv_int8=True,
                               self_kv_int8=True)
    plain_cache = tw.init_cache(tp, t(enc), CFG, max_len=8, cross_kv_int8=False,
                                self_kv_int8=False)
    int4_cache = tw.init_cache(tp, t(enc), CFG, max_len=8, **INT4)
    for cache, match in ((plain_cache, "requires an int8"), (int4_cache, "int4")):
        with pytest.raises(ValueError, match=match):
            tw.decode_step(tp, tok, 0, cache, CFG, scores_int8=True)
    for cache, kw in ((int8_cache, dict(scores_int8=True)), (int4_cache, {})):
        anc = torch.zeros((B // 3, 3, 8), dtype=torch.long)
        with pytest.raises(ValueError, match="ancestry"):
            tw.decode_step(tp, tok, 0, cache, CFG, beam_width=3, ancestry=anc, **kw)
    with pytest.raises(ValueError, match="int4"):
        tw.init_cache(tp, t(enc), CFG, max_len=8, head_minor=True, **INT4)
    # cross_kv_int4 alone: an int4 cross cache beside an unquantized self
    # cache, built as JAX builds it (tests/test_torch_mixed_cache.py).
    got = tw.init_cache(tp, t(enc), CFG, max_len=8, cross_kv_int4=True)
    want = jw.init_cache(jp, enc, CFG, max_len=8, cross_kv_int4=True)
    assert got.self_k_scale is None and want.self_k_scale is None
    assert got.self_k.dtype == torch.float32 and got.self_k.shape == want.self_k.shape
    assert got.cross_k.shape == want.cross_k.shape and got.cross_k.shape[-1] == hd // 2
    assert (got.cross_k.numpy() != np.asarray(want.cross_k)).mean() <= 1e-3
    np.testing.assert_allclose(got.cross_k_scale.numpy(), np.asarray(want.cross_k_scale),
                               rtol=1e-5, atol=0)
    assert tw.use_head_minor(cross_kv_int8=True, self_kv_int8=True)
    assert not tw.use_head_minor(cross_kv_int8=True, self_kv_int8=True, self_kv_int4=True)
    assert not tw.use_head_minor(cross_kv_int8=False, self_kv_int8=True)


# --- decode loops ----------------------------------------------------------

@pytest.mark.parametrize("mode", ["s8", "int4"])
def test_greedy_tokens_equal_jax(model, mode):
    jp, tp, enc = model
    kw = S8 if mode == "s8" else INT4
    want = jax_greedy(jp, enc, CFG, jnp.asarray(PROMPT, jnp.int32), max_new_tokens=NEW, **kw)
    got = greedy_decode(tp, t(enc), CFG, PROMPT, max_new_tokens=NEW, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("K", [2, 3, 4])
@pytest.mark.parametrize("mode", ["s8", "int4"])
def test_beam_tokens_equal_jax(model, mode, K):
    """Physical-reorder beams: JAX with head_minor=True under scores_int8
    (its CPU default is the classic layout) and its classic int4 cache."""
    jp, tp, enc = model
    kw = S8 if mode == "s8" else INT4
    want = jax_beam(jp, enc, CFG, jnp.asarray(PROMPT, jnp.int32), num_beams=K,
                    max_new_tokens=NEW, head_minor=mode == "s8", **kw)
    got = beam_decode(tp, t(enc), CFG, PROMPT, num_beams=K, max_new_tokens=NEW, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if K == 4:
        assert not torch.equal(got, greedy_decode(tp, t(enc), CFG, PROMPT,
                                                  max_new_tokens=NEW, **kw))


# --- evaluator, service, CLI, gate ------------------------------------------

def _loaders(n=5, batch=3):
    from sar_tpu.data.collate import create_collator as jax_collator
    from sar_tpu.data.loader import DataLoader as JaxLoader
    from sar_tpu.data.synthetic import SyntheticASRDataset as JaxSynthetic
    from sar_tpu_torch.data import DataLoader, SyntheticASRDataset, create_collator
    kw = dict(num_frames=CFG.num_audio_frames)
    port = DataLoader(SyntheticASRDataset(CFG, size=n, seed=5), batch,
                      create_collator(CFG.sot_token_id, **kw), shuffle=False, drop_last=False)
    jax_side = JaxLoader(JaxSynthetic(CFG, size=n, seed=5), batch,
                         jax_collator(CFG.sot_token_id, **kw), shuffle=False, drop_last=False)
    return port, jax_side


class IdTokenizer:
    def decode(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.mark.parametrize("num_beams", [1, 2])
@pytest.mark.parametrize("mode", ["s8", "int4"])
def test_evaluator_equals_jax_evaluator(model, mode, num_beams):
    jp, tp, _ = model
    kw = dict(scores_int8=True) if mode == "s8" else dict(kv_int4=True)
    port_loader, jax_loader = _loaders()
    want = JaxEvaluator(CFG, jp, IdTokenizer(), language="english", max_new_tokens=NEW,
                        num_beams=num_beams, **kw).evaluate(jax_loader, return_predictions=True)
    ev = ASREvaluator(CFG, tp, IdTokenizer(), language="english", max_new_tokens=NEW,
                      num_beams=num_beams, device="cpu", **kw)
    assert (ev.kv_int8, ev.kv_int4, ev.scores_int8) == (
        (True, False, True) if mode == "s8" else (False, True, False))
    assert ev.evaluate(port_loader, return_predictions=True) == want
    jax.clear_caches()


def test_evaluator_refuses_what_jax_refuses(model):
    _, tp, _ = model
    for kw, match in ((dict(scores_int8=True, kv_int4=True), "does not compose"),
                      (dict(scores_int8=True, kv_int8=False, kv_int4=False),
                       "requires kv_int8")):
        with pytest.raises(ValueError, match=match):
            ASREvaluator(CFG, tp, device="cpu", **kw)
    # The unquantized cache, which JAX takes too, is ported.
    ev = ASREvaluator(CFG, tp, device="cpu", kv_int8=False)
    assert (ev.kv_int8, ev.kv_int4, ev.scores_int8) == (False, False, False)


def test_service_int4_and_s8_match_the_evaluator(model):
    from sar_tpu_torch.ops import mel
    from sar_tpu_torch.serving import TranscriptionService
    _, tp, _ = model
    rng = np.random.default_rng(8)
    clips = [rng.standard_normal(n).astype(np.float32) * 0.2 for n in (5000, 7000, 3000)]
    feats = mel.log_mel_spectrogram(torch.from_numpy(mel.stack_pad_audio(clips)),
                                    CFG.num_mel_bins)[:, :, :CFG.num_audio_frames]
    from sar_tpu_torch.decode import transcribe_tokens
    for kw in (dict(kv_int4=True), dict(scores_int8=True), dict(kv_int4=True, num_beams=2)):
        with TranscriptionService(CFG, tp, language="english", batch_size=3,
                                  max_wait_ms=300.0, max_new_tokens=NEW, device="cpu",
                                  **kw) as svc:
            got = [h.result(timeout=300.0) for h in [svc.submit(c) for c in clips]]
        ev = ASREvaluator(CFG, tp, language="english", max_new_tokens=NEW, device="cpu", **kw)
        assert got == transcribe_tokens(ev.tokens(feats), CFG, len(PROMPT))
    with pytest.raises(ValueError, match="does not compose"):
        TranscriptionService(CFG, tp, kv_int4=True, scores_int8=True, device="cpu")


def test_routed_service_takes_int4_and_turns_s8_off(model, caplog):
    from _torch_port import random_bank, to_numpy

    from sar_tpu.models import classifier as jclf
    from sar_tpu_torch.decode import transcribe_tokens
    from sar_tpu_torch.models import classifier as tclf
    from sar_tpu_torch.models import lora as tlora
    from sar_tpu_torch.models.convert import from_jax_params
    from sar_tpu_torch.models.router import AdapterRouter
    from sar_tpu_torch.ops import mel
    from sar_tpu_torch.serving import TranscriptionService
    _, tp, _ = model
    _, bank = random_bank(CFG, 2, 4, seed=3)
    jccfg = jclf.ClassifierConfig(input_dim=CFG.d_model, hidden_dims=(16,), num_classes=2,
                                  languages=("english", "german"))
    router = AdapterRouter(CFG, tp, bank, tlora.LoraConfig(r=4, alpha=8),
                           from_jax_params(to_numpy(jclf.init_classifier(jax.random.PRNGKey(5),
                                                                         jccfg))),
                           tclf.ClassifierConfig.from_dict(jccfg.to_dict()), device="cpu")
    rng = np.random.default_rng(9)
    clips = [rng.standard_normal(n).astype(np.float32) * 0.2 for n in (5000, 6000)]
    feats = mel.log_mel_spectrogram(torch.from_numpy(mel.stack_pad_audio(clips)),
                                    CFG.num_mel_bins)[:, :, :CFG.num_audio_frames]
    idx, _ = router.route(feats)
    enc = router.encode(feats, idx)
    for kw, kv_int4 in ((dict(kv_int4=True), True), (dict(scores_int8=True), False)):
        with caplog.at_level("WARNING"), TranscriptionService(
                router=router, batch_size=2, max_wait_ms=300.0, max_new_tokens=NEW,
                **kw) as svc:
            got = [h.result(timeout=300.0) for h in [svc.submit(c) for c in clips]]
        want = router.decode(enc, idx, NEW, kv_int4=kv_int4)
        assert got == transcribe_tokens(want, CFG, router.prompt_len)
    assert "bf16 scores" in caplog.text
    assert router.cache(enc, idx, NEW, kv_int4=True).cross_k.shape[-1] == hd // 2


@pytest.mark.parametrize("flags", [["--attn_scores", "int8"], ["--kv_cache", "int4"],
                                   ["--attn_scores", "int8", "--num_beams", "2"]])
def test_evaluate_cli_quantized_flags(model, tmp_path, flags, capsys):
    from sar_tpu_torch.scripts import evaluate_model
    args = ["--checkpoint", "none", "--model", "whisper-test", "--language", "english",
            "--data_sources", "synthetic", "--device", "cpu", "--max_samples", "4",
            "--batch_size", "2", "--max_new_tokens", "8", "--mixed_precision", "no",
            "--output_dir", str(tmp_path), *flags]
    res = evaluate_model.main(args)
    assert f"WER: {res['wer'] * 100:.2f}%" in capsys.readouterr().out
    assert json.loads((tmp_path / "metrics.json").read_text())["num_samples"] == 4
    parsed = evaluate_model.parse_args(args)
    assert (parsed.attn_scores, parsed.kv_cache) == (
        "int8" if "int8" in flags else "bf16", "int4" if "int4" in flags else "int8")


@pytest.mark.parametrize("quant", ["s8", "int4"])
def test_s8_gate_on_the_cpu_writes_only_where_asked(quant, tmp_path, monkeypatch):
    from sar_tpu_torch.scripts import s8_gate
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "report" / "gate.json"
    rc = s8_gate.main(["--device", "cpu", "--models", "whisper-test", "--batches", "2",
                       "--max_new_tokens", "6", "--quant", quant, "--output", str(out)])
    report = json.loads(out.read_text())
    assert rc == (0 if report["pass"] else 1)
    assert report["quant"] == quant and report["device"] == "cpu"
    assert report["kernel"] is False and len(report["cells"]) == 1
    cell = report["cells"][0]
    a, b = ("int4", "int8") if quant == "int4" else ("s8", "bf16")
    assert {"model", "batch", "agreement_twophase", "agreement_direct",
            f"decode_s_{a}", f"decode_s_{b}", "max_logit_delta"} <= set(cell)
    assert 0.0 <= cell["agreement_twophase"] <= 1.0 and cell["max_logit_delta"] >= 0.0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["report"]
    with pytest.raises(SystemExit):
        s8_gate.main(["--device", "cpu", "--models", "whisper-test"])   # no --output
