"""The captured decode loop on the card (marked `cuda`: it needs an NVIDIA
GPU with nvcc and skips elsewhere; chip_smoke.py's graphs phase runs the
same comparisons at whisper-small widths). Run on the card with
`python -m pytest tests/test_torch_graphs_cuda.py -m cuda -q --noconftest`.

At d_model 128 (2 heads of 64, the kernels' head_dim), bf16:
- a cluster launch (K3, K5, K7 through cudaLaunchKernelEx) captured in a
  CUDA graph replays to the eager result, bit for bit;
- one captured decode_step replays to its eager logits, bit for bit;
- a DecodeRunner with the real capture against one without: greedy tokens
  equal at the same `segment` over the head-minor int8, classic int8,
  bf16 and int4 caches, with `scores_int8`, and routed with mixed
  `adapter_idx`; beams of 4 over the ancestry path and the physical
  reorder; each batch through the runner gives that batch's tokens (the
  first batch runs eagerly and captures, the later ones replay);
- the launch and step counters after replays equal the eager run's;
- at whisper-small's decoder (12 layers of 768) and B=128, the captured
  greedy loop's tokens equal the eager loop's, and each step launches K13
  once and K14 36 times (3 per layer), eager and under replay;
- greedy with the fallback's options (sampling, logprobs, no-speech, the
  cap, a per-call prompt length, timestamps) captured against eager, one
  program for every prompt length, temperature and seed;
- a capture-unsafe operation in the step raises and nothing runs on
  eagerly."""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def model(dev):
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.models.config import get_config
    cfg = dataclasses.replace(get_config("whisper-test"), d_model=128, encoder_heads=2,
                              decoder_heads=2, ffn_dim=256)
    params = whisper.cast_params(
        whisper.init_params(cfg, torch.Generator(device=dev).manual_seed(6), dev), torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(7)
    encs = [torch.randn((3, cfg.max_source_positions, cfg.d_model), generator=g,
                        device=dev).to(torch.bfloat16) for _ in range(2)]
    return cfg, params, encs


def _capture(fn):
    """fn() run eagerly once (the warm-up), then captured; returns the
    graph and the static output of the capture."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        out = fn()
    return g, out


@pytest.mark.parametrize("kernel", ["K3", "K5", "K7"])
def test_cluster_launch_captures_and_replays(dev, kernel):
    from sar_tpu_torch.ops import decode_cross
    L, B, S, H, K = 2, 3, 1536, 12, 4
    D = H * 64
    g = torch.Generator(device=dev).manual_seed(0)
    kq = torch.randint(-127, 128, (L, B, S, D), generator=g, device=dev, dtype=torch.int8)
    vq = torch.randint(-127, 128, (L, B, S, D), generator=g, device=dev, dtype=torch.int8)
    ks = torch.rand((L, B, H, S), generator=g, device=dev) * 0.01
    vs = torch.rand((L, B, H, S), generator=g, device=dev) * 0.01
    ks[..., 1500:] = 0.0
    vs[..., 1500:] = 0.0
    shape = (B, D) if kernel == "K3" else (B, K, D)
    q = (torch.randn(shape, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    if kernel == "K7":
        from sar_tpu_torch.models.whisper import quantize_kv
        qq, qs = quantize_kv(q.reshape(B, K, H, 64))
        q, qs = qq.reshape(B, K, D), qs.reshape(B, K * H, 1)
        fn = lambda: decode_cross.cross_decode_attention(q, qs, kq, ks, vq, vs, layer=1,
                                                         n_heads=H)
    else:
        fn = lambda: decode_cross.cross_decode_attention_exact(q, kq, ks, vq, vs, layer=1,
                                                               n_heads=H)
    want = fn()
    graph, out = _capture(fn)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    q.neg_()                        # the graph reads the static input's new values
    want = fn()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_captured_decode_step_replays_its_eager_logits(dev, model):
    from sar_tpu_torch.models import whisper
    cfg, params, encs = model
    cache = whisper.init_cache(params, encs[0], cfg, 16, cross_kv_int8=True,
                               self_kv_int8=True)
    tok = torch.tensor([1, 2, 3], device=dev)
    ref = whisper.DecodeCache(*(None if x is None else x.clone() for x in cache))
    want, _ = whisper.decode_step(params, tok, 0, ref, cfg, self_len=8)
    graph, out = _capture(lambda: whisper.decode_step(params, tok, 0, cache, cfg,
                                                      self_len=8)[0])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


INT8 = dict(cross_kv_int8=True, self_kv_int8=True)
CACHES = {"int8_head_minor": INT8, "int8_classic": dict(INT8, head_minor=False),
          "bf16": {}, "int4": dict(cross_kv_int4=True, self_kv_int4=True)}


def _runners(cfg, params, **kw):
    from sar_tpu_torch.decode.graphs import CudaGraphCapture, DecodeRunner
    return (DecodeRunner(params, cfg, capture=CudaGraphCapture, **kw),
            DecodeRunner(params, cfg, **kw))


def _counts():
    from sar_tpu_torch.decode import segments
    from sar_tpu_torch.ops import decode_cross, layer_norm
    return (decode_cross.LAUNCHES, decode_cross.STREAM_LAUNCHES, decode_cross.BEAM_LAUNCHES,
            decode_cross.S8_LAUNCHES, decode_cross.S8_BEAM_LAUNCHES, layer_norm.LAUNCHES,
            layer_norm.ADD_LAUNCHES, *segments.STEPS.values())


def _run_both(run_captured, run_eager, encs):
    """Three batches (A, B, A) through the captured runner and the eager
    one: the tokens of each equal, and the counters of the captured run
    equal the eager run's."""
    got, want, moved = [], [], []
    for run, out in ((run_captured, got), (run_eager, want)):
        c0 = _counts()
        for e in (encs[0], encs[1], encs[0]):
            out.append(run(e))
        torch.cuda.synchronize()
        moved.append([a - b for a, b in zip(_counts(), c0)])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[0], got[1])           # each batch its own tokens
    assert moved[0] == moved[1] and any(moved[0])
    return got


@pytest.mark.parametrize("cache,scores_int8", [
    *((c, False) for c in CACHES), ("int8_head_minor", True)])
def test_captured_greedy_equals_eager(dev, model, cache, scores_int8):
    cfg, params, encs = model
    cap, eager = _runners(cfg, params)
    prompt, total = cfg.prompt_ids("english"), 4 + 20

    def greedy(runner):
        return lambda e: runner.greedy(runner.prep(e, total, **CACHES[cache]), prompt,
                                       scores_int8=scores_int8, segment=8)
    _run_both(greedy(cap), greedy(eager), encs)
    st = cap.graph_stats()
    assert st["graphs"] >= 1 and st["nodes"] > 0 and st["programs"] == 1


def test_captured_routed_greedy_equals_eager(dev, model):
    from sar_tpu_torch.models import lora as lora_lib
    cfg, params, encs = model
    g = torch.Generator(device=dev).manual_seed(3)
    lcfg = lora_lib.LoraConfig(r=4, alpha=8, target_modules=("q_proj", "v_proj"))
    bank = lora_lib.map_with_path(
        lambda path, x: ((torch.randn(x.shape, generator=g, device=dev) * 0.05
                          if path[-1] == "b" else x).to(torch.bfloat16)),
        lora_lib.init_lora(g, cfg, lcfg, num_adapters=3))
    cap, eager = _runners(cfg, params, lora=bank, lora_scale=lcfg.scale)
    prompts = torch.tensor([cfg.prompt_ids(l) for l in ("english", "german", "hindi")],
                           device=dev)
    idxs = iter([torch.tensor(i, device=dev) for i in ([0, 1, 2], [2, 2, 1], [0, 1, 2]) * 2])

    def routed(runner):
        def run(e):
            idx = next(idxs)
            return runner.greedy(runner.prep(e, 24, adapter_idx=idx, **INT8), prompts[idx],
                                 adapter_idx=idx, segment=8)
        return run
    _run_both(routed(cap), routed(eager), encs)


def test_captured_small_b128_launches_k13_and_k14_per_step(dev):
    """whisper-small's decoder with random bf16 weights (every decoder bias
    and LayerNorm parameter drawn, so the folded biases count) over a
    random encoder output of 128 rows: the captured greedy loop against the
    eager one over two batches, tokens equal, counters equal, and per step
    one K13 and 3 x 12 K14 launches."""
    from sar_tpu_torch.decode import segments
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.models.config import get_config
    from sar_tpu_torch.ops import layer_norm as ln_ops
    cfg = dataclasses.replace(get_config("whisper-small"), encoder_layers=1)
    g = torch.Generator(device=dev).manual_seed(11)
    params = whisper.init_params(cfg, g, dev)
    params["decoder"] = whisper.tree_map(
        lambda t: t + 0.05 * torch.randn(t.shape, generator=g, device=dev)
        if t.is_floating_point() else t, params["decoder"])
    params = whisper.cast_params(params, torch.bfloat16)
    encs = [torch.randn((128, cfg.max_source_positions, cfg.d_model), generator=g,
                        device=dev).to(torch.bfloat16) for _ in range(2)]
    cap, eager = _runners(cfg, params)
    prompt, total, L = cfg.prompt_ids("english"), 4 + 24, cfg.decoder_layers
    got, moved = [], []
    for runner in (cap, eager):
        c0 = _counts()
        k0 = (ln_ops.LAUNCHES, ln_ops.ADD_LAUNCHES, segments.STEPS["greedy"])
        got.append([runner.greedy(runner.prep(e, total, **INT8), prompt, segment=8)
                    for e in (encs[0], encs[1], encs[0])])
        torch.cuda.synchronize()
        moved.append([a - b for a, b in zip(_counts(), c0)])
        k13, k14, steps = (a - b for a, b in zip(
            (ln_ops.LAUNCHES, ln_ops.ADD_LAUNCHES, segments.STEPS["greedy"]), k0))
        assert steps > 0 and k13 == steps and k14 == 3 * L * steps
    for a, b in zip(*got):
        assert torch.equal(a, b)
    assert moved[0] == moved[1]
    assert cap.graph_stats()["graphs"] >= 1


@pytest.mark.parametrize("cache,scores_int8", [("int8_head_minor", False),
                                               ("int8_head_minor", True),
                                               ("int4", False)],
                         ids=["ancestry", "s8-reorder", "int4-reorder"])
def test_captured_beam_equals_eager(dev, model, cache, scores_int8):
    cfg, params, encs = model
    cap, eager = _runners(cfg, params)
    prompt, total, K = cfg.prompt_ids("english"), 4 + 20, 4

    def beam(runner):
        return lambda e: runner.beam(runner.prep(e, total, self_batch=3 * K, **CACHES[cache]),
                                     prompt, num_beams=K, scores_int8=scores_int8, segment=8)
    _run_both(beam(cap), beam(eager), encs)


@pytest.mark.parametrize("timestamps", [False, True], ids=["sampled", "timestamped"])
def test_captured_greedy_options_equal_eager(dev, model, timestamps):
    """The fallback decode's options inside the captured loop: sampling at
    T = 0 and T > 0 with a seed, logprobs, no-speech and the cap, under a
    conditioned prompt buffer whose forced length changes per call. The
    tokens equal the eager runner's bit for bit, the sums and
    probabilities to 1e-3 / 1e-4, and one captured program serves every
    call."""
    cfg, params, encs = model
    cap, eager = _runners(cfg, params)
    std = cfg.prompt_ids("english", no_timestamps=not timestamps)
    width, total = len(std) + 3, len(std) + 3 + 16
    calls = [(len(std), 0.0, 1), (len(std) + 2, 0.0, 2), (len(std), 0.7, 3),
             (len(std) + 3, 1.0, 4)]
    got, want = [], []
    for runner, out in ((cap, got), (eager, want)):
        for plen, temp, seed in calls:
            for e in encs:
                buf = [cfg.prev_sot_token_id, 140, 141][:plen - len(std)] + std
                buf += [cfg.eos_token_id] * (width - len(buf))
                out.append(runner.greedy(
                    runner.prep(e, total, **INT8), buf, prompt_len=plen, temperature=temp,
                    seed=seed, with_logprobs=True, with_no_speech=True,
                    no_speech_pos=plen - len(std), max_gen_tokens=12,
                    timestamps=timestamps, segment=8))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0]) and torch.equal(g[2], w[2])
        torch.testing.assert_close(g[1], w[1], atol=1e-3, rtol=0)
        torch.testing.assert_close(g[3], w[3], atol=1e-4, rtol=0)
    assert not torch.equal(got[0][0], got[4][0])            # T > 0 samples
    assert cap.graph_stats()["programs"] == 1


def test_a_capture_unsafe_step_raises(dev, model, monkeypatch):
    from sar_tpu_torch.decode.graphs import CudaGraphCapture, DecodeRunner
    from sar_tpu_torch.models import whisper
    cfg, params, encs = model
    real = whisper.decode_step

    def syncing(*a, **k):
        logits, cache = real(*a, **k)
        logits.sum().item()                    # a host read: not capturable
        return logits, cache
    run = DecodeRunner(params, cfg, capture=CudaGraphCapture)
    monkeypatch.setattr(whisper, "decode_step", syncing)
    with pytest.raises(RuntimeError):
        run.greedy(run.prep(encs[0], 24, **INT8), cfg.prompt_ids("english"))
    assert run._programs == {}
    monkeypatch.setattr(whisper, "decode_step", real)
    torch.cuda.synchronize()                   # the device is still usable
    out = run.greedy(run.prep(encs[0], 24, **INT8), cfg.prompt_ids("english"))
    assert out.shape == (3, 24)
