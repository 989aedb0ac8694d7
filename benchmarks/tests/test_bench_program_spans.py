"""CPU tests of the readers of the program's own spans and counters
(metrics/_program.py and the seven readers that use it): the tiny serve and
eval cells, traced on the CPU, report the span metrics that a CPU run can
read (the service's queue wait and batch wall) and none of the device's
(device milliseconds, idle shares) or `capture_s` (capture is off); the
readers' arithmetic on a stand-in trace; a program without the spans or the
counter gives nothing to read."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from benchmarks import harness
from benchmarks.tests.conftest import TINY_CELLS, drive

NEW = {"queue_wait_ms", "serve_batch_ms", "lid_ms_per_batch", "serve_decode_ms",
       "device_idle_in_batch.serve", "device_idle_in_decode.eval", "capture_s"}
ON_THE_CPU = {"tiny.serve": {"queue_wait_ms", "serve_batch_ms"}, "tiny.eval": set()}


def _longer_stretch(root) -> None:
    """tiny.serve with a profiled stretch of ~1 s rather than ~0.3 s, which
    can hold no batch's start: the cell's file rewritten in the temporary
    checkout."""
    path = root / "benchmarks" / "workloads" / "tiny.serve.json"
    path.write_text(json.dumps(dict(TINY_CELLS["tiny.serve"], profile_s=1.0)))


@pytest.mark.parametrize("cell", sorted(ON_THE_CPU))
def test_traced_tiny_cell_reports_what_a_cpu_run_can_read(checkout, cell):
    _longer_stretch(checkout)
    rc, last, err = drive(checkout, cell, trace=1)
    assert rc == 0, err
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in spec["per_layer"] if cell in m.get("workloads", [])}
    assert NEW & listed == ({"device_idle_in_decode.eval", "capture_s"} if cell == "tiny.eval"
                            else NEW - {"device_idle_in_decode.eval"})
    assert set(last["metrics"]) & NEW == ON_THE_CPU[cell]
    for name in ON_THE_CPU[cell]:
        assert last["metrics"][name]["value"] > 0
    # No sar.* annotation is counted as device work.
    assert not any(n.startswith("sar.") for n, _ in last["breakdown"]["device_ops"])


def _rec(name, start, end, span_id, trace_id=None, parent=None, device_ms=None):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end, span_id=span_id,
                           trace_id=trace_id, parent=parent, device_ms=device_ms)


def _stand_in(monkeypatch, records):
    from sar_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "spans",
                        lambda name=None: [r for r in records if name in (None, r.name)])


def test_readers_on_a_stand_in_trace(monkeypatch):
    """A stretch of 0..1000 ns holding two batches (the second's stages
    partly after the stretch), a batch before it and kernels busy 100..200
    and 500..900."""
    records = [
        _rec("serve.batch", -300, -10, 1, "batch-0"),
        _rec("serve.queue_wait", -400, -300, 2, "request-0", parent=1),
        _rec("serve.batch", 100, 400, 3, "batch-1"),
        _rec("serve.queue_wait", 50, 100, 4, "request-1", parent=3),
        _rec("route", 110, 150, 5, "batch-1", parent=3, device_ms=2.0),
        _rec("decode", 200, 390, 6, "batch-1", parent=3, device_ms=10.0),
        _rec("serve.batch", 600, 1200, 7, "batch-2"),
        _rec("serve.queue_wait", 350, 600, 8, "request-2", parent=7),
        _rec("route", 610, 650, 9, "batch-2", parent=7, device_ms=4.0),
        _rec("decode", 700, 1100, 10, "batch-2", parent=7, device_ms=20.0),
        _rec("decode", 1300, 1400, 11, None, device_ms=99.0),
    ]
    _stand_in(monkeypatch, records)
    trace = harness.Trace(kernels=[("k", 100, 200), ("k", 500, 900)],
                          host=[("bench.profiled", 0, 1000, True), ("op", 5, 6, False)])

    def read(name):
        return harness.load_reader(name).read(trace)
    assert read("queue_wait_ms") == pytest.approx((50 + 250) / 2 / 1e6)
    assert read("serve_batch_ms") == pytest.approx((300 + 600) / 2 / 1e6)
    assert read("lid_ms_per_batch") == pytest.approx(3.0)
    assert read("serve_decode_ms") == pytest.approx(15.0)
    # Batches cover 100..400 and 600..1200, cut to the stretch: 100..400 and
    # 600..1000 (700 ns); busy inside: 100 + 300. No higher than the idle
    # share of the whole stretch (600 of 1000 ns).
    assert read("device_idle_in_batch.serve") == pytest.approx(100 * (1 - 400 / 700))
    assert read("device_idle_in_batch.serve") <= 100 * (1 - 500 / 1000)
    # The eval reading takes each decode span in the stretch on the device:
    # its device time ending at its host end (100 and 200 ns here: 290..390
    # and 900..1100, cut to 900..1000, which no kernel touches).
    for r in records:
        if r.name == "decode":
            r.device_ms /= 1e5
    assert read("device_idle_in_decode.eval") == pytest.approx(100.0)
    records[5].end_ns = 600            # 500..600 now, all busy
    assert read("device_idle_in_decode.eval") == pytest.approx(100 * (1 - 100 / 200))
    # No kernels: nothing to read, not 0.
    trace.kernels = []
    assert read("device_idle_in_batch.serve") is None


def test_a_program_without_the_spans_or_the_counter_gives_nothing(monkeypatch):
    """The readers also run over a tree from before `profiling.spans` and
    `graphs.CAPTURE` (a traced run of an earlier commit under this
    benchmark): there they read nothing and raise nothing."""
    from sar_tpu_torch.decode import graphs
    from sar_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(graphs, "CAPTURE")
    trace = harness.Trace(kernels=[("k", 0, 10)], host=[("op", 0, 10, False)])
    for name in sorted(NEW):
        assert harness.load_reader(name).read(trace) is None, name
    monkeypatch.setattr(graphs, "CAPTURE", {"graphs": 0, "nodes": 0, "seconds": 0.0},
                        raising=False)
    assert harness.load_reader("capture_s").read(trace) is None
    monkeypatch.setattr(graphs, "CAPTURE", {"graphs": 3, "nodes": 30, "seconds": 2.5})
    assert harness.load_reader("capture_s").read(trace) == 2.5
