"""The port's spans and capture counter (utils/profiling.py,
decode/graphs.py::CAPTURE) on the CPU, whisper-test at fp32:
- with no profiler active, an evaluator batch and a routed service's
  batches record no span, open no `record_function` range and create no
  timing event;
- under a profiler on another thread than the serving worker, the worker
  records each batch's spans with their parents and the batch's trace id,
  and each request's `serve.queue_wait` from its submit to its batch's
  start;
- on the profiling thread, each span's logged edges lie within 1 ms of
  its `sar.*` annotation in the profile;
- `CAPTURE` moves at a capture (a stand-in seam here) and stays moved
  through the runner's rollback of the launch counters;
- the service's stats give the queue wait and the batch wall.
The `cuda`-marked case (skipped without a card) captures a span inside a
CUDA graph: it records no event there, and the span around the replays
times them. Run it on the card with
`python -m pytest tests/test_torch_tracing.py -m cuda -q --noconftest`.
"""

import threading

import numpy as np
import pytest
import torch

from sar_tpu_torch.decode import graphs
from sar_tpu_torch.evaluation import ASREvaluator
from sar_tpu_torch.models import classifier as clf
from sar_tpu_torch.models import lora as lora_lib
from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import get_config
from sar_tpu_torch.models.router import AdapterRouter
from sar_tpu_torch.ops import decode_cross
from sar_tpu_torch.serving import TranscriptionService
from sar_tpu_torch.utils import profiling

CFG = get_config("whisper-test")
NEW = 4
BATCH_STAGES = {"serve.features", "mel", "route", "encode", "prep", "decode",
                "decode.segment", "decode.sync", "detokenize"}


@pytest.fixture(scope="module")
def params():
    return whisper.init_params(CFG, torch.Generator().manual_seed(0), torch.device("cpu"))


@pytest.fixture(scope="module")
def router(params):
    ccfg = clf.ClassifierConfig(input_dim=CFG.d_model, hidden_dims=(8,), num_classes=2,
                                languages=("english", "german"), encoder_layer=0)
    lcfg = lora_lib.LoraConfig(r=2, alpha=4)
    bank = lora_lib.init_lora(torch.Generator().manual_seed(1), CFG, lcfg, num_adapters=2)
    return AdapterRouter(CFG, params, bank, lcfg,
                         clf.init_classifier(torch.Generator().manual_seed(2), ccfg), ccfg,
                         device="cpu")


def _clips(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(int(k)).astype(np.float32) * 0.1
            for k in rng.integers(3000, 8000, size=n)]


def _serve(router, clips, batch_size=2):
    """Send `clips` at once to a routed service and wait for them ->
    (the request handles, the service's stats)."""
    with TranscriptionService(router=router, batch_size=batch_size, max_wait_ms=200.0,
                              max_new_tokens=NEW) as svc:
        reqs = [svc.submit(c) for c in clips]
        for r in reqs:
            r.result(timeout=300.0)
        return reqs, svc.stats()


def test_no_profiler_records_nothing(params, router, monkeypatch):
    ranges, events = [], []
    record_function = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: ranges.append(a) or record_function(*a))
    monkeypatch.setattr(profiling, "_event", lambda: events.append(1))
    assert not profiling.active()
    before = len(profiling.spans())
    ev = ASREvaluator(CFG, params, language="english", max_new_tokens=NEW, device="cpu")
    ev.from_audio(_clips(3))
    _serve(router, _clips(4))
    assert len(profiling.spans()) == before
    assert ranges == [] and events == []
    with profiling.span("anything") as rec:
        assert rec is None
    assert profiling.span("a") is profiling.span("b")      # one shared no-op


def test_worker_spans_under_a_profiler_on_another_thread(router):
    """The profiler runs on this thread; the worker records its spans."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        seen = threading.Event()
        threading.Thread(target=lambda: profiling.active() and seen.set()).start()
        assert seen.wait(10.0)
        reqs, _ = _serve(router, _clips(5))
    ids = {f"request-{r.id}": r for r in reqs}
    by_id = {r.span_id: r for r in profiling.spans()}
    waits = [r for r in by_id.values() if r.name == "serve.queue_wait" and r.trace_id in ids]
    assert len(waits) == len(reqs)
    batches = {w.parent: by_id[w.parent] for w in waits}
    assert len(batches) >= 3
    for w in waits:
        batch = batches[w.parent]
        assert batch.name == "serve.batch"
        assert w.start_ns == ids[w.trace_id].t_submit_ns and w.end_ns == batch.start_ns
        assert w.device_ms is None
    # Every stage of a batch carries the batch's trace id and hangs under it.
    for batch in batches.values():
        assert batch.trace_id.startswith("batch-") and batch.parent is None
        stages = [r for r in by_id.values() if r.trace_id == batch.trace_id and r is not batch]
        assert {r.name for r in stages} == BATCH_STAGES
        for r in stages:
            up = r
            while up.parent != batch.span_id:
                up = by_id[up.parent]
            assert batch.start_ns <= r.start_ns <= r.end_ns <= batch.end_ns
            assert r.device_ms is None              # no CUDA here


def test_span_edges_match_their_profile_annotations(params):
    ev = ASREvaluator(CFG, params, language="english", max_new_tokens=NEW, device="cpu")
    clips = _clips(2)
    ev.from_audio(clips)
    start = len(profiling.spans())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ev.from_audio(clips)
    recs = profiling.spans()[start:]
    assert {r.name for r in recs} == {"frontend", "mel", "encode", "prep", "decode",
                                      "decode.segment", "decode.sync", "detokenize"}
    notes = sorted((e for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("sar.")), key=lambda e: e.start_ns())
    assert all(e.is_user_annotation() for e in notes)
    for name in {r.name for r in recs}:
        mine = sorted((r for r in recs if r.name == name), key=lambda r: r.start_ns)
        theirs = [e for e in notes if e.name() == f"sar.{name}"]
        assert len(mine) == len(theirs)
        for r, e in zip(mine, theirs):
            assert abs(r.start_ns - e.start_ns()) < 1_000_000
            assert abs(r.end_ns - (e.start_ns() + e.duration_ns())) < 1_000_000


class _CountingSeam:
    """A capture seam's stand-in: the body runs eagerly; each capture adds
    a graph of 5 nodes and 0.25 s to CAPTURE, as CudaGraphCapture does, and
    moves K3's launch counter, which the runner rolls back."""

    def warm_up(self, body):
        body()

    def capture(self, body):
        for key, add in (("graphs", 1), ("nodes", 5), ("seconds", 0.25)):
            graphs.CAPTURE[key] += add
        decode_cross.LAUNCHES += 3
        return body


def test_capture_counter_survives_the_rollback(params, monkeypatch):
    monkeypatch.setattr(graphs, "CAPTURE", {"graphs": 0, "nodes": 0, "seconds": 0.0})
    enc = torch.randn((2, CFG.max_source_positions, CFG.d_model),
                      generator=torch.Generator().manual_seed(4))
    prompt = CFG.prompt_ids("english")
    total = len(prompt) + 3

    def batch(run):
        before = decode_cross.LAUNCHES
        run.greedy(run.prep(enc, total, cross_kv_int8=True, self_kv_int8=True), prompt,
                   segment=1)
        return decode_cross.LAUNCHES - before

    eager = batch(graphs.DecodeRunner(params, CFG))
    run = graphs.DecodeRunner(params, CFG, capture=_CountingSeam)
    assert batch(run) == eager                # the capture's launches rolled back
    n = graphs.CAPTURE["graphs"]
    assert 1 <= n <= len(graphs.segments.grid(total, 1))
    assert graphs.CAPTURE == {"graphs": n, "nodes": 5 * n, "seconds": pytest.approx(0.25 * n)}
    batch(run)                                # replays capture nothing
    assert graphs.CAPTURE["graphs"] == n


def test_service_stats_give_queue_wait_and_batch_wall(router):
    reqs, st = _serve(router, _clips(5))
    assert st["batches"] >= 3
    assert 0 <= st["queue_wait_ms_p50"] <= st["queue_wait_ms_p95"]
    assert st["batch_ms_p50"] > 0
    assert st["queue_wait_ms_p50"] + st["batch_ms_p50"] <= st["latency_ms_p95"] + 1.0


@pytest.mark.cuda
def test_a_captured_span_records_no_event_and_the_replay_span_times_it():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    dev = torch.device("cuda", 0)
    x = torch.zeros(1 << 22, device=dev)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        x.add_(1)
    torch.cuda.current_stream().wait_stream(s)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            with profiling.span("inside") as inside:
                for _ in range(20):
                    x.mul_(1.0001).add_(1)
        with profiling.span("replays") as outside:
            for _ in range(10):
                graph.replay()
        torch.cuda.synchronize()
    recs = {r.span_id: r for r in profiling.spans()}
    assert recs[inside.span_id].device_ms is None
    assert recs[outside.span_id].device_ms > 0
