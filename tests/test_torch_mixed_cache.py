"""The mixed-precision decode caches against sar_tpu on the CPU (whisper-test
at fp32, the JAX weights bridged over and scaled x5 so that tokens depend on
the input): the six (cross, self) pairs whose sides differ in precision,
plain (the compute dtype), int8 or int4, each side by its own flags (an int4
flag wins over its side's int8 flag, which the (int8, int4) and (int4, int8)
cases pass too).

Per pair: the `init_cache` fields against JAX's (int8/int4 values equal up to
a flip at a .5 boundary in at most 1e-3 of them, scales 1e-5 relative, plain
values 1e-5 absolute), the logits of 4 teacher-forced `decode_step`s within
1e-4 absolute, and `greedy_decode` tokens EXACTLY equal to JAX's at 10 new
tokens. Beam tokens (2 beams) equal to JAX's `beam_decode` for (int8, plain),
which reads its self cache through the ancestry, and (int8, int4), which
reorders it physically. A `DecodeRunner` (through a stand-in of the capture
seam) gives the eager loop's tokens over a mixed cache. The `scores_int8`,
`ancestry` and `head_minor` refusals raise where JAX's do. Two API points:
`greedy_decode_from_cache(return_cache=True)` and
`use_head_minor(scores_int8=)`, each against JAX."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import get_config, jax_whisper, t

from sar_tpu.decode.beam import beam_decode as jax_beam
from sar_tpu.decode.greedy import greedy_decode_from_cache as jax_from_cache
from sar_tpu.models import whisper as jw
from sar_tpu_torch.decode import beam_decode, graphs, greedy_decode, segments
from sar_tpu_torch.decode.greedy import greedy_decode_from_cache
from sar_tpu_torch.models import whisper as tw

CFG = get_config("whisper-test")
B = 3
HD = CFG.d_model // CFG.decoder_heads
PROMPT = CFG.prompt_ids("english")
NEW = 10
STEPS = 4
# The six mixed (cross, self) pairs and flags that ask for them.
PAIRS = {
    ("plain", "int8"): dict(self_kv_int8=True),
    ("plain", "int4"): dict(self_kv_int4=True),
    ("int8", "plain"): dict(cross_kv_int8=True),
    ("int8", "int4"): dict(cross_kv_int8=True, self_kv_int8=True, self_kv_int4=True),
    ("int4", "plain"): dict(cross_kv_int4=True),
    ("int4", "int8"): dict(cross_kv_int8=True, cross_kv_int4=True, self_kv_int8=True),
}
IDS = [f"{c}-{s}" for c, s in PAIRS]
BEAM_PAIRS = [("int8", "plain"), ("int8", "int4")]


@pytest.fixture(scope="module")
def model():
    jp, tp = jax_whisper(CFG, seed=0, w_scale=5.0)
    mel = np.random.default_rng(7).standard_normal(
        (B, CFG.num_mel_bins, CFG.num_audio_frames)).astype(np.float32)
    return jp, tp, jw.encode(jp, jnp.asarray(mel), CFG)


def _step_tokens():
    return np.random.default_rng(3).integers(0, CFG.vocab_size, size=(STEPS, B))


@pytest.fixture(scope="module")
def jax_ref(model):
    """The JAX package's outputs for every mixed pair, computed once: the
    cache, the teacher-forced logits, the greedy loop's outputs with its
    logprobs and final cache (greedy_decode is init_cache, then this loop),
    and the beam tokens of BEAM_PAIRS."""
    jp, _, enc = model
    step = jax.jit(lambda tok, pos, cache: jw.decode_step(jp, tok, pos, cache, CFG))
    ref = {}
    for pair, kw in PAIRS.items():
        cache = jw.init_cache(jp, enc, CFG, max_len=8, **kw)
        step_cache, logits = cache, []
        for pos, tok in enumerate(_step_tokens()):
            lj, step_cache = step(jnp.asarray(tok, jnp.int32), jnp.int32(pos), step_cache)
            logits.append(np.asarray(lj))
        full = jw.init_cache(jp, enc, CFG, max_len=len(PROMPT) + NEW, **kw)
        *greedy, final = jax_from_cache(jp, full, CFG, jnp.asarray(PROMPT, jnp.int32),
                                        return_cache=True, with_logprobs=True)
        ref[pair] = dict(cache=_numpy(cache), logits=logits,
                         greedy=[np.asarray(x) for x in greedy], final=_numpy(final))
        if pair in BEAM_PAIRS:
            ref[pair]["beam"] = np.asarray(jax_beam(jp, enc, CFG, jnp.asarray(PROMPT, jnp.int32),
                                                    num_beams=2, max_new_tokens=NEW, **kw))
    jax.clear_caches()
    return ref


def _numpy(cache) -> dict:
    return {k: None if v is None else np.asarray(v) for k, v in cache._asdict().items()}


def _lanes(x: np.ndarray, int4: bool) -> np.ndarray:
    """The quantized values of an s8 field: int4 bytes unpacked into their
    two nibble lanes (a flip moves one lane by one)."""
    if not int4:
        return x.astype(np.int32)
    lo, hi = tw.unpack_kv4(t(x))
    return np.concatenate([lo.numpy(), hi.numpy()], -1).astype(np.int32)


def assert_cache_equal(got: tw.DecodeCache, want: dict, rows=None) -> None:
    """Field by field, at the stated tolerances; `rows` (default all) cuts
    the self fields to their first rows."""
    for name, a in got._asdict().items():
        b = want[name]
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a = a.numpy()
        assert a.shape == b.shape, name
        if name.startswith("self") and rows is not None:
            a, b = a[:, :, :, :rows], b[:, :, :, :rows]
        if a.dtype == np.int8:
            d = np.abs(_lanes(a, a.shape[-1] == HD // 2) - _lanes(b, b.shape[-1] == HD // 2))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, name
        elif name.endswith("scale"):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=name)
        else:
            assert a.dtype == np.float32, name
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("pair", list(PAIRS), ids=IDS)
def test_init_cache_matches_jax(model, jax_ref, pair):
    _, tp, enc = model
    got = tw.init_cache(tp, t(enc), CFG, max_len=8, **PAIRS[pair])
    assert tw.cache_kind(**PAIRS[pair]) == "/".join(pair)
    hd = {"plain": HD, "int8": HD, "int4": HD // 2}
    assert got.cross_k.shape[-1] == hd[pair[0]] and got.self_k.shape[-1] == hd[pair[1]]
    assert_cache_equal(got, jax_ref[pair]["cache"])


@pytest.mark.parametrize("pair", list(PAIRS), ids=IDS)
def test_decode_steps_match_jax(model, jax_ref, pair):
    _, tp, enc = model
    cache = tw.init_cache(tp, t(enc), CFG, max_len=8, **PAIRS[pair])
    for pos, (tok, want) in enumerate(zip(_step_tokens(), jax_ref[pair]["logits"])):
        got, cache = tw.decode_step(tp, torch.from_numpy(tok), pos, cache, CFG)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("pair", list(PAIRS), ids=IDS)
def test_greedy_tokens_equal_jax(model, jax_ref, pair):
    _, tp, enc = model
    got = greedy_decode(tp, t(enc), CFG, PROMPT, max_new_tokens=NEW, **PAIRS[pair])
    np.testing.assert_array_equal(got.numpy(), jax_ref[pair]["greedy"][0])
    assert len({tuple(r) for r in got[:, len(PROMPT):].tolist()}) > 1   # the input matters


@pytest.mark.parametrize("pair", BEAM_PAIRS, ids=[f"{c}-{s}" for c, s in BEAM_PAIRS])
def test_beam_tokens_equal_jax(model, jax_ref, pair):
    _, tp, enc = model
    got = beam_decode(tp, t(enc), CFG, PROMPT, num_beams=2, max_new_tokens=NEW,
                      **PAIRS[pair])
    np.testing.assert_array_equal(got.numpy(), jax_ref[pair]["beam"])


class StandInSeam:
    """The capture seam's stand-in: the "replay" is the body, run eagerly."""
    graphs, nodes, seconds = (), 0, 0.0

    def warm_up(self, body):
        body()

    def capture(self, body):
        return body


@pytest.mark.parametrize("num_beams,pair", [(1, ("int4", "plain")), (2, ("int8", "int4"))])
def test_runner_replays_the_eager_loop(model, num_beams, pair):
    """A DecodeRunner's static cache of the mixed kind, its captured (stand-
    in) segments replayed over two batches: the eager loop's tokens, and the
    steps counted as classic."""
    _, tp, enc = model
    kw = PAIRS[pair]
    total = len(PROMPT) + NEW
    run = graphs.DecodeRunner(tp, CFG, capture=StandInSeam)
    for e in (t(enc), t(enc).flip(0)):
        if num_beams == 1:
            want = greedy_decode(tp, e, CFG, PROMPT, max_new_tokens=NEW, **kw)
        else:
            want = beam_decode(tp, e, CFG, PROMPT, num_beams=num_beams, max_new_tokens=NEW,
                               **kw)
        cache = run.prep(e, total, self_batch=B * num_beams, **kw)
        assert tw.cache_kind(**kw) in run._cache_key
        before = dict(segments.STEPS)
        got = (run.greedy(cache, PROMPT) if num_beams == 1 else
               run.beam(cache, PROMPT, num_beams=num_beams))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert segments.STEPS["classic"] > before["classic"]
        assert all(segments.STEPS[k] == before[k] for k in ("greedy", "beam", "s8"))
    assert run.graph_stats()["programs"] == 1


@pytest.mark.parametrize("pair", list(PAIRS), ids=IDS)
def test_refusals_raise_where_jax_does(model, pair):
    """scores_int8 (needs both sides int8, no int4) and ancestry (no int4
    self side) raise with JAX's message exactly where JAX's decode_step
    raises (traced abstractly: its checks come before any work), and
    head_minor=True over a mixed pair raises in both."""
    jp, tp, enc = model
    K, T = 2, 8
    kw = PAIRS[pair]
    anc = np.zeros((B, K, T), np.int64)
    anc[:, :, 0] = np.arange(K)

    def jax_error(rows, **case):
        def run(e):
            c = jw.init_cache(jp, e, CFG, max_len=T, self_batch=rows, **kw)
            return jw.decode_step(jp, jnp.zeros(rows, jnp.int32), jnp.int32(0), c, CFG, **case)
        try:
            jax.eval_shape(run, enc)
        except ValueError as e:
            return str(e)

    def port_error(rows, **case):
        c = tw.init_cache(tp, t(enc), CFG, max_len=T, self_batch=rows, **kw)
        try:
            tw.decode_step(tp, torch.zeros(rows, dtype=torch.long), 0, c, CFG, **case)
        except ValueError as e:
            return str(e)

    s8 = [f(B, scores_int8=True) for f in (jax_error, port_error)]
    beams = [jax_error(B * K, beam_width=K, ancestry=jnp.asarray(anc, jnp.int32)),
             port_error(B * K, beam_width=K, ancestry=t(anc))]
    assert s8[0] == s8[1] and beams[0] == beams[1]
    # Every mixed pair has a plain or an int4 side; only an int4 self side
    # refuses the ancestry.
    assert s8[0] is not None and (beams[0] is not None) == (pair[1] == "int4")
    with pytest.raises(ValueError):
        jw.init_cache(jp, enc, CFG, max_len=T, head_minor=True, **kw)
    with pytest.raises(ValueError):
        tw.init_cache(tp, t(enc), CFG, max_len=T, head_minor=True, **kw)


def test_every_pair_builds_and_runs_a_step(model):
    """None of the nine pairs raises: the cache kinds are distinct, and the
    runner's prep and a decode step run over each."""
    _, tp, enc = model
    precisions = {"plain": {}, "int8": "kv_int8", "int4": "kv_int4"}
    kinds = set()
    run = graphs.DecodeRunner(tp, CFG)
    for c, s in itertools.product(precisions, repeat=2):
        kw = {f"{side}_{precisions[p]}": True for side, p in (("cross", c), ("self", s))
              if p != "plain"}
        kind = tw.cache_kind(head_minor=False, **kw)
        assert kind == f"{c}/{s}" and kind in tw.CACHE_KINDS
        kinds.add(kind)
        cache = run.prep(t(enc), 6, head_minor=False, **kw)
        logits, _ = tw.decode_step(tp, torch.zeros(B, dtype=torch.long), 0, cache, CFG)
        assert torch.isfinite(logits).all()
    assert len(kinds) == 9 and len(tw.CACHE_KINDS) == 10


@pytest.mark.parametrize("pair", [("int8", "plain"), ("plain", "int4")],
                         ids=["int8-plain", "plain-int4"])
def test_return_cache_equals_jax(model, jax_ref, pair):
    """greedy_decode_from_cache(return_cache=True): the final DecodeCache
    last in the flat tuple, after the logprobs, as JAX's: the cross fields
    as built, the self fields of every row the JAX loop ran (it stops after
    the step at which every row has finished, the port at the end of the
    segment)."""
    _, tp, enc = model
    total = len(PROMPT) + NEW
    cache = tw.init_cache(tp, t(enc), CFG, max_len=total, **PAIRS[pair])
    got = greedy_decode_from_cache(tp, cache, CFG, PROMPT, return_cache=True,
                                   with_logprobs=True)
    tokens, sum_lp, n_scored = jax_ref[pair]["greedy"]
    assert isinstance(got, tuple) and len(got) == 4 and got[-1] is cache
    np.testing.assert_array_equal(got[0].numpy(), tokens)
    np.testing.assert_allclose(got[1].numpy(), sum_lp, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), n_scored)
    gen = tokens[:, len(PROMPT):] == CFG.eos_token_id
    rows = int((gen.argmax(1) + len(PROMPT)).max()) if gen.any(1).all() else total - 1
    assert_cache_equal(got[-1], jax_ref[pair]["final"], rows=rows)
    alone = greedy_decode_from_cache(tp, tw.init_cache(tp, t(enc), CFG, max_len=total,
                                                       **PAIRS[pair]),
                                     CFG, PROMPT, return_cache=True)
    assert len(alone) == 2 and torch.equal(alone[0], got[0])


@pytest.mark.parametrize("flags", [dict(cross_kv_int8=c8, self_kv_int8=s8, cross_kv_int4=c4,
                                        self_kv_int4=s4)
                                   for c8, s8, c4, s4 in itertools.product((False, True),
                                                                           repeat=4)])
def test_use_head_minor_takes_scores_int8_as_jax_on_an_accelerator(monkeypatch, flags):
    """JAX's answer on its accelerator (its default backend reported as
    "tpu"), with and without scores_int8 and under a mesh."""
    got = {(s8, mesh): tw.use_head_minor(scores_int8=s8, mesh=mesh, **flags)
           for s8 in (False, True) for mesh in (None, "mesh")}
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want = {(s8, mesh): jw.use_head_minor(scores_int8=s8, mesh=mesh, **flags)
            for s8 in (False, True) for mesh in (None, "mesh")}
    assert got == want
