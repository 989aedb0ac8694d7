"""The decode loop's segments and its captured form, on the CPU (whisper-test
at fp32, the JAX weights bridged over and scaled x5 so that tokens depend
on the input):

- `greedy_decode(segment=s)` tokens EXACTLY equal to sar_tpu's at the same
  `segment`, for s in {0, 1, 5, 32}, over the four caches: unquantized
  classic, classic int8, head-minor int8 (JAX's jnp path on the CPU, the
  Pallas kernel's plain twin) and int4;
- `decode_step(self_len=hi)` against the full self cache: logits within
  1e-5 absolute and the same argmax, over every self-attention form;
- the host syncs: one per segment run, with the tokens of a loop that
  checks after every step;
- the DecodeRunner's bookkeeping through a stand-in of the capture seam
  (the real capture needs the card: tests/test_torch_graphs_cuda.py): a
  new key captures anew and the same key replays, two batches through one
  runner equal two fresh runs, the counters after N replays are N times
  the captured change, a failed capture raises and leaves nothing behind;
- the entry points' `capture` argument on the CPU.
Beam tokens per segment: tests/test_torch_beam_segments.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper, t

from sar_tpu.decode.greedy import greedy_decode as jax_greedy
from sar_tpu.models import whisper as jw
from sar_tpu_torch.decode import beam_decode, graphs, greedy_decode, segments
from sar_tpu_torch.decode.greedy import greedy_decode_from_cache
from sar_tpu_torch.evaluation import ASREvaluator
from sar_tpu_torch.models import whisper as tw
from sar_tpu_torch.ops import decode_cross

CFG = get_config("whisper-test")
B = 3
PROMPT = CFG.prompt_ids("english")
NEW = 5
INT8 = dict(cross_kv_int8=True, self_kv_int8=True)
CACHES = {"plain": {}, "int8_classic": dict(INT8, head_minor=False),
          "int8_head_minor": dict(INT8, head_minor=True),
          "int4": dict(cross_kv_int4=True, self_kv_int4=True)}


@pytest.fixture(scope="module")
def model():
    jp, tp = jax_whisper(CFG, seed=0, w_scale=5.0)
    mel = np.random.default_rng(7).standard_normal(
        (B, CFG.num_mel_bins, CFG.num_audio_frames)).astype(np.float32)
    return jp, tp, jw.encode(jp, jnp.asarray(mel), CFG)


def test_segment_grid_is_jax_s():
    assert segments.grid(10, 0) == [(0, 9, 10)]
    assert segments.grid(10, 9) == [(0, 9, 10)]             # covers the loop
    assert segments.grid(10, 4) == [(0, 4, 4), (4, 8, 8), (8, 9, 10)]
    assert segments.grid(9, 1) == [(p, p + 1, p + 1) for p in range(8)]
    with pytest.raises(ValueError):
        segments.grid(10, -1)


@pytest.mark.parametrize("segment", [0, 1, 5, 32])
@pytest.mark.parametrize("cache", list(CACHES))
def test_greedy_tokens_equal_jax_per_segment(model, cache, segment):
    jp, tp, enc = model
    kw = CACHES[cache]
    # One program per case: outside jit, JAX compiles one loop per segment.
    want = jax.jit(functools.partial(jax_greedy, cfg=CFG, max_new_tokens=NEW,
                                     segment=segment, **kw))(
        jp, enc, prompt_ids=jnp.asarray(PROMPT, jnp.int32))
    got = greedy_decode(tp, t(enc), CFG, PROMPT, max_new_tokens=NEW, segment=segment, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len({tuple(r) for r in got[:, len(PROMPT):].tolist()}) > 1   # the input matters
    jax.clear_caches()


@pytest.mark.parametrize("form", [*CACHES, "s8", "beam_ancestry"])
def test_decode_step_self_len_reads_the_prefix(model, form):
    """Steps at positions 0..5 of a 12-row self cache, each read at
    self_len = the segment's high-water mark (pos + 1 and a few more)
    against the whole cache."""
    _, tp, enc = model
    T, K = 12, 2 if form == "beam_ancestry" else 1
    kw = CACHES.get(form, INT8 if form == "s8" else dict(INT8, head_minor=True))
    step_kw = dict(scores_int8=form == "s8")
    full = tw.init_cache(tp, t(enc), CFG, max_len=T, self_batch=B * K, **kw)
    cut = tw.init_cache(tp, t(enc), CFG, max_len=T, self_batch=B * K, **kw)
    rng = np.random.default_rng(4)
    anc = torch.from_numpy(rng.integers(0, K, size=(B, K, T)))
    if K > 1:
        step_kw.update(beam_width=K, ancestry=anc)
    for pos in range(6):
        anc[:, :, pos] = torch.arange(K)
        tok = torch.from_numpy(rng.integers(0, CFG.vocab_size, size=B * K))
        lf, full = tw.decode_step(tp, tok, pos, full, CFG, **step_kw)
        lc, cut = tw.decode_step(tp, tok, pos, cut, CFG, self_len=min(pos + 1 + pos % 3, T),
                                 **step_kw)
        np.testing.assert_allclose(lc.numpy(), lf.numpy(), atol=1e-5, rtol=0)
        assert torch.equal(lc.argmax(-1), lf.argmax(-1))
    with pytest.raises(ValueError):
        tw.decode_step(tp, tok, 6, cut, CFG, self_len=6, **step_kw)


def _per_step_greedy(tp, cache, P):
    """The greedy loop with a stop check after every step (the loop before
    segments), from a prepared cache."""
    total = cache.self_k.shape[3]
    tokens = torch.full((B, total), CFG.eos_token_id, dtype=torch.int64)
    tokens[:, :P] = torch.tensor(PROMPT)
    finished = torch.zeros(B, dtype=torch.bool)
    for pos in range(total - 1):
        if bool(finished.all()):
            break
        logits, cache = tw.decode_step(tp, tokens[:, pos], pos, cache, CFG)
        if pos + 1 >= P:
            nxt = torch.where(finished, CFG.eos_token_id, logits.argmax(-1))
            finished |= nxt == CFG.eos_token_id
            tokens[:, pos + 1] = nxt
    return tokens


def _eos_model(tp):
    """The weights with the final LN pinned to a constant row u and
    token_embed[eos] = 10u: every generated position picks EOS."""
    tp = {**tp, "decoder": dict(tp["decoder"])}
    tp["decoder"]["ln"] = {"scale": torch.zeros(CFG.d_model), "bias": torch.ones(CFG.d_model)}
    emb = tp["decoder"]["token_embed"].clone()
    emb[CFG.eos_token_id] = 10.0
    tp["decoder"]["token_embed"] = emb
    return tp


@pytest.mark.parametrize("segment", [1, 2, 5])
def test_one_host_sync_per_segment(model, segment):
    """Free running: the syncs equal the segments run and the steps are
    theirs, the tokens the per-step loop's; with every row done at the
    first generated position, the loop stops after that segment."""
    _, tp, enc = model
    P, total = len(PROMPT), len(PROMPT) + 2 * NEW
    grid = segments.grid(total, segment)
    for weights, n_seg in ((tp, None), (_eos_model(tp), None)):
        want = _per_step_greedy(weights, tw.init_cache(weights, t(enc), CFG, total), P)
        done = (want[:, P:] == CFG.eos_token_id).any(1).all()
        if done:     # the segment holding the step that finished the last row
            last = int((want[:, P:] == CFG.eos_token_id).int().argmax(1).max()) + P - 1
            n_seg = next(s for s, (lo, hi, _) in enumerate(grid) if lo <= last < hi) + 1
        else:
            n_seg = len(grid)
        syncs, steps = segments.HOST_SYNCS, dict(segments.STEPS)
        got = greedy_decode(weights, t(enc), CFG, PROMPT, max_new_tokens=2 * NEW,
                            segment=segment)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert segments.HOST_SYNCS - syncs == n_seg
        assert segments.STEPS["classic"] - steps["classic"] == grid[n_seg - 1][1]
    assert n_seg == (P - 1) // segment + 1          # the EOS model: done at pos P - 1
    syncs = segments.HOST_SYNCS
    beam_decode(_eos_model(tp), t(enc), CFG, PROMPT, num_beams=2, max_new_tokens=2 * NEW,
                segment=segment)
    assert 1 <= segments.HOST_SYNCS - syncs <= len(grid)


class StandInSeam:
    """The capture seam's stand-in: warm_up runs the body; capture counts
    itself, moves K3's launch counter by LAUNCHES_PER_CAPTURE (and its
    large-batch form's by STREAM_PER_CAPTURE) as the wrappers do while
    their launches are recorded, and returns the body as the "replay" (run
    eagerly on the CPU)."""
    LAUNCHES_PER_CAPTURE = 7
    STREAM_PER_CAPTURE = 5

    def __init__(self):
        self.captured = 0

    def warm_up(self, body):
        body()

    def capture(self, body):
        self.captured += 1
        decode_cross.LAUNCHES += self.LAUNCHES_PER_CAPTURE
        decode_cross.STREAM_LAUNCHES += self.STREAM_PER_CAPTURE
        return body


def _runner(tp, seams, **kw):
    def factory():
        seams.append(StandInSeam())
        return seams[-1]
    return graphs.DecodeRunner(tp, CFG, capture=factory, **kw)


def test_runner_keys_refills_and_counter_replays(model):
    _, tp, enc = model
    P = len(PROMPT)
    total = P + 2 * NEW
    encs = [t(enc), t(enc).flip(0)]               # two batches of one shape
    seams = []
    run = _runner(tp, seams)
    fresh = [greedy_decode(tp, e, CFG, PROMPT, max_new_tokens=2 * NEW, segment=4, **INT8)
             for e in encs]
    n_seg = len(segments.grid(total, 4))
    outs = []
    for _ in range(3):
        for e in encs:
            cache = run.prep(e, total, **INT8)
            outs.append(run.greedy(cache, PROMPT, segment=4))
    # Refill: every batch equals its fresh run; one seam (one key), each
    # segment captured at most once (a batch that finishes early leaves
    # the later segments to a later batch).
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o.numpy(), fresh[i % 2].numpy())
    assert len(seams) == 1 and 1 <= seams[0].captured <= n_seg
    prog = next(iter(run._programs.values()))
    assert seams[0].captured == sum(r is not None for r in prog.replays)
    # The same key replays; a new flag or shape captures anew (a new seam).
    run.greedy(run.prep(encs[0], total, **INT8), PROMPT, segment=4)
    assert len(seams) == 1
    run.greedy(run.prep(encs[0], total, **INT8), PROMPT, segment=4, scores_int8=True)
    assert len(seams) == 2
    run.greedy(run.prep(encs[0][:2], total, **INT8), PROMPT, segment=4)
    assert len(seams) == 3 and len(run._programs) == 1   # the old shape's went


def test_runner_counter_replay_is_exact(model):
    """With every row done only at the end (no EOS in the vocabulary's
    reach), every batch runs every segment: after N batches K3's counter
    reads (N - 1) x the captured change and the steps N x total - 1."""
    _, tp, enc = model
    total = len(PROMPT) + NEW
    seams = []
    run = _runner(tp, seams)
    n_seg = len(segments.grid(total, 2))
    launches, steps = decode_cross.LAUNCHES, segments.STEPS["greedy"]
    stream = decode_cross.STREAM_LAUNCHES
    N = 3
    for _ in range(N):
        run.greedy(run.prep(t(enc), total, **INT8), PROMPT, segment=2,
                   suppress_ids=(CFG.eos_token_id,))
    assert seams[0].captured == n_seg
    # The first batch ran eagerly (its captures' counts put back), the
    # others replayed: 7 per replayed segment.
    assert decode_cross.LAUNCHES - launches == (N - 1) * n_seg * StandInSeam.LAUNCHES_PER_CAPTURE
    assert decode_cross.STREAM_LAUNCHES - stream == \
        (N - 1) * n_seg * StandInSeam.STREAM_PER_CAPTURE
    assert segments.STEPS["greedy"] - steps == N * (total - 1)


def test_runner_beam_and_routed_refills_equal_fresh_runs(model):
    from _torch_port import random_bank
    _, tp, enc = model
    total = len(PROMPT) + NEW
    seams = []
    run = _runner(tp, seams)
    for e in (t(enc), t(enc).flip(0)):
        cache = run.prep(e, total, self_batch=2 * B, **INT8)
        got = run.beam(cache, PROMPT, num_beams=2, segment=3)
        want = beam_decode(tp, e, CFG, PROMPT, num_beams=2, max_new_tokens=NEW, **INT8)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    _, bank = random_bank(CFG, 2, 4, seed=9, std=0.3)
    run = _runner(tp, seams, lora=bank, lora_scale=2.0)
    prompts = torch.tensor([CFG.prompt_ids(l) for l in ("english", "german", "hindi")])
    for idx in (torch.tensor([1, 0, 1]), torch.tensor([0, 0, 1])):
        cache = run.prep(t(enc), total, adapter_idx=idx, **INT8)
        got = run.greedy(cache, prompts, adapter_idx=idx, segment=3)
        want = greedy_decode(tp, t(enc), CFG, prompts, max_new_tokens=NEW, lora=bank,
                             adapter_idx=idx, lora_scale=2.0, **INT8)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_a_failed_capture_raises_and_drops_the_program(model):
    _, tp, enc = model
    total = len(PROMPT) + NEW

    class Failing(StandInSeam):
        def capture(self, body):
            raise RuntimeError("operation not permitted when stream is capturing")

    run = graphs.DecodeRunner(tp, CFG, capture=Failing)
    cache = run.prep(t(enc), total, **INT8)
    with pytest.raises(RuntimeError, match="capturing"):
        run.greedy(cache, PROMPT)
    assert run._programs == {}
    with pytest.raises(ValueError):      # a cache that is not the runner's
        run.greedy(tw.init_cache(tp, t(enc), CFG, total, **INT8), PROMPT)


def test_entry_points_capture_argument_on_the_cpu(model):
    from sar_tpu_torch.models import classifier as clf
    from sar_tpu_torch.models import lora as lora_lib
    from sar_tpu_torch.models.router import AdapterRouter
    _, tp, enc = model
    with pytest.raises(ValueError):
        ASREvaluator(CFG, tp, language="english", device="cpu", capture=True)
    ev = ASREvaluator(CFG, tp, language="english", device="cpu", max_new_tokens=NEW)
    assert not ev.capture and ev.runner.capture is None
    assert not ASREvaluator(CFG, tp, device="cpu", capture=False).capture
    with pytest.raises(ValueError):
        graphs.resolve_capture(True, torch.device("cuda", 0), kernels=False)
    assert not graphs.resolve_capture(None, torch.device("cuda", 0), kernels=False)
    ccfg = clf.ClassifierConfig(input_dim=CFG.d_model, hidden_dims=(8,), num_classes=2,
                                languages=("english", "german"), encoder_layer=0)
    lcfg = lora_lib.LoraConfig(r=2, alpha=2)
    bank = lora_lib.init_lora(torch.Generator().manual_seed(0), CFG, lcfg, num_adapters=2)
    args = (CFG, tp, bank, lcfg, clf.init_classifier(torch.Generator().manual_seed(1), ccfg),
            ccfg)
    with pytest.raises(ValueError):
        AdapterRouter(*args, device="cpu", capture=True)
    # The evaluator's dec over its prep equals greedy_decode_from_cache.
    mel = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (B, CFG.num_mel_bins, CFG.num_audio_frames)).astype(np.float32))
    cache = ev.prep(mel)
    ref = tw.init_cache(tp, ev.encode(mel), CFG, ev.total, **INT8)
    np.testing.assert_array_equal(
        ev.dec(cache).numpy(),
        greedy_decode_from_cache(tp, ref, CFG, PROMPT).numpy())


def test_a_dropped_runner_frees_its_cache_without_the_collector(model):
    """No reference cycle holds a runner: its static cache and programs go
    as soon as its owner drops it (the benchmark CLI drops a row's runner
    before its comparison decode builds a second cache)."""
    import gc
    import weakref
    _, tp, enc = model
    gc.disable()
    try:
        run = _runner(tp, [])
        cache = run.prep(t(enc), len(PROMPT) + NEW, **INT8)
        run.greedy(cache, PROMPT, segment=2)
        alive = weakref.ref(cache.self_k)
        del cache, run
        assert alive() is None
    finally:
        gc.enable()
