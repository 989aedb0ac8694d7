"""OWSM on the port (models/ebranchformer.py, ops/fbank.py and the decoder's
OWSM options in models/whisper.py) against the plain float32 reference of
the benchmark (benchmarks/reference/owsm.py, fbank.py), on the CPU at
owsm-test (d 64, 4 heads, 2 + 2 layers, cgMLP 128, time kernels 31 and 7,
V 256, the 30 s window: 3001 frames, 749 encoder frames), with seeded
random weights in their published form (benchmarks/weights_owsm.py,
upcast to fp32) and the port's serving form of them
(`ebranchformer.port_params`).

- the frontend against the reference's (3001 frames from 30 s);
- the encoder through exact attention and through the padded K1 route
  (kernels off: K1's and K12's plain versions), T = 749 not a multiple of
  128, also with garbage in the pad rows; the same garbage read by the
  depthwise convolutions (no `t_valid`) must fail;
- teacher-forced logits; greedy decode through the unquantized classic
  cache and the int8 head-minor cache against the reference's full
  forward logits; the evaluator's `from_audio` against that greedy;
- that dropping k's bias (a rewrite of `port_params`) is exact;
- an EOS equal to SOT (OWSM's <sos/eos>) inside the prompt;
- the q/v LoRA hooks of the E-Branchformer MHSA and of the decoder's self
  and cross attention with a two-adapter bank, per row;
- the spans and the block counter.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from _torch_port import t  # noqa: F401  (pins torch to one thread)

from benchmarks import weights_owsm
from benchmarks.reference import fbank as ref_fbank
from benchmarks.reference import owsm as ref
from sar_tpu_torch.decode.greedy import greedy_decode, transcribe_tokens
from sar_tpu_torch.evaluation import ASREvaluator
from sar_tpu_torch.models import ebranchformer, whisper
from sar_tpu_torch.models.config import get_config
from sar_tpu_torch.ops import dwconv
from sar_tpu_torch.ops import fbank as fbank_ops
from sar_tpu_torch.ops.mel import stack_pad_audio
from sar_tpu_torch.utils import profiling

CFG = get_config("owsm-test")
C = dataclasses.asdict(CFG)
PROMPT = CFG.prompt_ids("hindi")
NEW = 6


@pytest.fixture(scope="module")
def weights():
    """(published fp32 weights for the reference, the port's serving form).
    The depthwise kernels are drawn at std 0.5 rather than 0.02: at 0.02 a
    kernel of 31 taps passes a hundredth of its input, and what the time
    convolutions do (their padding above all) would hardly show."""
    W = whisper.tree_map(lambda x: x.float(), weights_owsm.make(C, 11, "cpu"))
    for name in ("cgmlp_conv", "merge_conv"):
        W["encoder"]["layers"][name]["w"].mul_(25.0)
    return W, ebranchformer.port_params(W, CFG)


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(5)
    return [rng.standard_normal(int(16000 * s)).astype(np.float32) * 0.1 for s in (7.3, 2.1)]


@pytest.fixture(scope="module")
def feats(weights, clips):
    return fbank_ops.fbank(torch.from_numpy(stack_pad_audio(clips)), weights[1]["mvn"])


@pytest.fixture(scope="module")
def ref_enc(weights, feats):
    W, _ = weights
    with torch.no_grad():
        return [ref.encode(W, C, f) for f in feats]


def test_fbank_matches_the_reference(weights, clips, feats):
    want = ref_fbank.fbank(clips, weights[0]["mvn"], CFG.num_mel_bins)
    assert feats.shape == want.shape == (2, 80, 3001) == (2, 80, CFG.num_audio_frames)
    # fp32 DFT-as-GEMM against a float64 FFT: the power's relative error is
    # ~1e-6, which the log turns into an absolute ~1e-6 and the division
    # by std >= 1 does not enlarge; 1e-4 leaves room for quiet bins.
    torch.testing.assert_close(feats.double(), want, atol=1e-4, rtol=0)


def _garbage_pad(monkeypatch):
    """Every block starts with noise of 100 in its pad rows (>= t_valid)."""
    block = ebranchformer.block
    g = torch.Generator().manual_seed(0)

    def noisy(x, *args, t_valid, **kwargs):
        x = x.clone()
        x[:, t_valid:] = 100.0 * torch.randn(x[:, t_valid:].shape, generator=g)
        return block(x, *args, t_valid=t_valid, **kwargs)
    monkeypatch.setattr(ebranchformer, "block", noisy)


# fp32 on both sides, the same products in another order (and K1's plain
# version's masked softmax over 768 padded keys): observed ~1e-6 against
# states of ~4; 1e-4 is two decades above that and far below the
# differences an unmasked pad makes (~1e-2, below).
ENC_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("route", ["exact", "hm", "hm_garbage_pad"])
def test_encoder_matches_the_reference(weights, feats, ref_enc, route, monkeypatch):
    _, P = weights
    if route == "hm_garbage_pad":
        _garbage_pad(monkeypatch)
    with torch.no_grad():
        got = whisper.encode(P, feats, CFG, flash=False if route == "exact" else "hm",
                             kernels=False)
    assert got.shape == (2, 749, 64) and 749 % 128
    for g, w in zip(got, ref_enc):
        torch.testing.assert_close(g, w, **ENC_TOL)


def test_garbage_pad_without_the_zeroing_fails(weights, feats, ref_enc, monkeypatch):
    """The depthwise convolutions' reading of the pad rows as zeros is what
    keeps the pad out: without it the same garbage reaches the last valid
    frames."""
    _, P = weights
    _garbage_pad(monkeypatch)
    conv = dwconv.depthwise_conv_time_reference
    monkeypatch.setattr(dwconv, "depthwise_conv_time_reference",
                        lambda *args, t_valid=None, **kw: conv(*args, **kw))
    with torch.no_grad():
        got = whisper.encode(P, feats, CFG, flash="hm", kernels=False)
    err = (got[0] - ref_enc[0]).abs().amax(-1)
    assert err[-(CFG.cgmlp_kernel // 2):].min() > 10 * ENC_TOL["atol"]
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got[0], ref_enc[0], **ENC_TOL)


def test_teacher_forced_logits_match_the_reference(weights, ref_enc):
    W, P = weights
    toks = torch.tensor(PROMPT + [7, 30, 200, 9])
    enc = torch.stack(ref_enc)
    with torch.no_grad():
        got = whisper.decode_train(P, enc, toks[None].expand(2, -1).contiguous(), CFG)
        for g, e in zip(got, ref_enc):
            # fp32 on both sides; logits of ~0.5.
            torch.testing.assert_close(g, ref.decoder_logits(W, C, e, toks),
                                       atol=1e-5, rtol=1e-5)


def _stepped_logits(P, enc, tokens, **flags):
    """decode_step's logits [B, T - 1, V] over prompt + greedy tokens."""
    cache = whisper.init_cache(P, enc, CFG, tokens.shape[1], kernels=False, **flags)
    rows = []
    for pos in range(tokens.shape[1] - 1):
        logits, cache = whisper.decode_step(P, tokens[:, pos], pos, cache, CFG,
                                            kernels=False)
        rows.append(logits)
    return torch.stack(rows, 1)


@pytest.mark.parametrize("cache", ["classic", "int8_head_minor"])
def test_greedy_decode_matches_the_reference_forward(weights, feats, ref_enc, cache):
    """Prefill and decode through the cache against the reference's full
    teacher-forced forward over the same tokens."""
    W, P = weights
    flags = {} if cache == "classic" else dict(cross_kv_int8=True, self_kv_int8=True)
    with torch.no_grad():
        enc = whisper.encode(P, feats, CFG, flash="hm", kernels=False)
        toks = greedy_decode(P, enc, CFG, PROMPT, max_new_tokens=NEW, kernels=False, **flags)
        got = _stepped_logits(P, enc, toks, **flags)
        assert toks.shape == (2, len(PROMPT) + NEW)
        for b, e in enumerate(ref_enc):
            want = ref.decoder_logits(W, C, e, toks[b, :-1])
            assert torch.equal(toks[b, len(PROMPT):], got[b, len(PROMPT) - 1:].argmax(-1))
            if cache == "classic":
                # fp32 throughout: the cached step is the forward's arithmetic.
                torch.testing.assert_close(got[b], want, atol=1e-5, rtol=1e-5)
            else:
                # Symmetric per-row int8 K/V: each entry rounds by up to half
                # a step of 1/254 of its row's largest; the logits (spread
                # ~0.17) move by ~1e-4 (observed). 2e-3 leaves room; a wrong
                # cache moves them by the spread itself.
                torch.testing.assert_close(got[b], want, atol=2e-3, rtol=0)


def test_evaluator_from_audio_runs_the_owsm_path(weights, clips, feats):
    """ASREvaluator.from_audio (the ESPnet frontend from the params' "mvn",
    the E-Branchformer encoder, the int8 head-minor cache, the runner's
    greedy loop) gives the ids of the module-level greedy over the same
    features."""
    _, P = weights
    ev = ASREvaluator(CFG, P, language="hindi", max_new_tokens=NEW, kv_int8=True,
                      flash="hm", kernels=False, device="cpu")
    got = ev.from_audio(clips)
    with torch.no_grad():
        enc = whisper.encode(P, feats, CFG, flash="hm", kernels=False)
        toks = greedy_decode(P, enc, CFG, PROMPT, max_new_tokens=NEW, kernels=False,
                             cross_kv_int8=True, self_kv_int8=True)
    assert got == transcribe_tokens(toks, CFG, prompt_len=len(PROMPT))


def test_dropping_k_bias_is_exact(weights, ref_enc):
    """softmax(q.(k + b)) = softmax(q.k): the reference with every k bias
    zeroed (as the port drops them) gives the same logits; zeroing the v
    biases instead does not (the comparison can see a bias)."""
    W, _ = weights
    toks = torch.tensor(PROMPT + [7, 30, 200])

    def zeroed(names):
        Z = whisper.tree_map(lambda x: x, W)
        for side, name in names:
            lay = Z[side]["layers"]
            lay[name] = dict(lay[name], b=torch.zeros_like(lay[name]["b"]))
        return Z
    feats = torch.zeros(80, 3001)
    with torch.no_grad():
        base = ref.decoder_logits(W, C, ref.encode(W, C, feats), toks)
        Zk = zeroed([("encoder", "k"), ("decoder", "self_k"), ("decoder", "cross_k")])
        no_k = ref.decoder_logits(Zk, C, ref.encode(Zk, C, feats), toks)
        Zv = zeroed([("encoder", "v"), ("decoder", "self_v"), ("decoder", "cross_v")])
        no_v = ref.decoder_logits(Zv, C, ref.encode(Zv, C, feats), toks)
    # fp32: the same softmax of scores shifted by a constant per row.
    torch.testing.assert_close(no_k, base, atol=1e-6, rtol=1e-5)
    assert (no_v - base).abs().max() > 1e-3


def test_eos_equal_to_sot_inside_the_prompt(weights, feats):
    """OWSM's <sos/eos> opens the prompt: no row may finish there, and the
    EOS search of the output starts after the prompt."""
    _, P = weights
    assert CFG.eos_token_id == CFG.sot_token_id == PROMPT[0]
    eos = CFG.eos_token_id
    with torch.no_grad():
        enc = whisper.encode(P, feats, CFG, flash="hm", kernels=False)
        toks = greedy_decode(P, enc, CFG, PROMPT, max_new_tokens=NEW, kernels=False,
                             suppress_ids=(eos,), cross_kv_int8=True, self_kv_int8=True)
    ids = transcribe_tokens(toks, CFG, prompt_len=len(PROMPT))
    assert [len(r) for r in ids] == [NEW, NEW] and eos not in sum(ids, [])
    buf = torch.tensor([PROMPT + [5, 6, eos, eos], PROMPT + [eos, 9, eos, eos]])
    assert transcribe_tokens(buf, CFG, prompt_len=len(PROMPT)) == [[5, 6], []]


def test_qv_lora_hooks_with_a_two_adapter_bank(weights, ref_enc, feats):
    """The E-Branchformer MHSA's q/v and the decoder's self/cross q/v
    adapted per row from a bank of two, against the reference's
    scale * (x @ A) @ B."""
    W, P = weights
    g = torch.Generator().manual_seed(4)
    L, d, r, A, scale = CFG.encoder_layers, CFG.d_model, 4, 2, 2.0

    def hook():
        return {"a": 0.3 * torch.randn((L, A, d, r), generator=g),
                "b": 0.3 * torch.randn((L, A, r, d), generator=g)}
    bank = {"encoder": {"q": hook(), "v": hook()},
            "decoder": {k: hook() for k in ("self_q", "self_v", "cross_q", "cross_v")}}
    toks = torch.tensor(PROMPT + [7, 30, 200])
    idx = [1, 0]
    with torch.no_grad():
        enc = whisper.encode(P, feats, CFG, flash="hm", kernels=False, lora=bank,
                             adapter_idx=idx, lora_scale=scale)
        got = whisper.decode_train(P, enc, toks[None].expand(2, -1).contiguous(), CFG,
                                   lora=bank, adapter_idx=idx, lora_scale=scale)
        for b, i in enumerate(idx):
            ad = ref.Adapter(bank, i, scale)
            e = ref.encode(W, C, feats[b], adapter=ad)
            torch.testing.assert_close(enc[b], e, **ENC_TOL)
            want = ref.decoder_logits(W, C, e, toks, adapter=ad)
            torch.testing.assert_close(got[b], want, atol=1e-5, rtol=1e-5)
            # The adapters move the logits: the comparison sees them.
            assert (want - ref.decoder_logits(W, C, ref_enc[b], toks)).abs().max() > 1e-2


def test_spans_and_block_counter(weights, feats):
    _, P = weights
    before = dict(ebranchformer.BLOCKS)
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        whisper.encode(P, feats, CFG, flash="hm", kernels=False)
    assert ebranchformer.BLOCKS[749] - before.get(749, 0) == CFG.encoder_layers
    names = [s.name for s in profiling.spans()[-(1 + 2 * CFG.encoder_layers):]]
    assert names == ["encode.subsample"] + ["ebf.cgmlp", "ebf.merge"] * CFG.encoder_layers
