"""CPU tests of the benchmark harness at whisper-test's size (kernels and
capture off): each driver runs a short window and prints the contract's
last line; a cell, a configuration and a per-layer metric are found by name
as added files; the import check; the reference's independence; the
open-loop schedule; the kernel counts; planted faults turn `correct`
false. The control's reading at the cells' own sizes needs the card
(`test_bench_control_cuda.py`)."""

from __future__ import annotations

import ast
import json
import math

import numpy as np
import pytest

from benchmarks import harness
from benchmarks.counts import whisper as counts
from benchmarks.tests.conftest import REPO, TINY_CELLS, drive, tiny_entry
from benchmarks.traffic import arrivals

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _last_line_ok(last: dict) -> None:
    assert KEYS <= set(last) and set(last) - KEYS <= {"checks", "breakdown"}
    assert list(last)[-1] == "checks"
    assert last["device"]["count"] == 1
    for c in last["checks"]:
        assert set(c) == {"name", "value", "limit", "ok"}


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_driver_prints_the_contract_line(checkout, cell):
    rc, last, err = drive(checkout, cell, trace=0)
    assert rc == 0, err
    _last_line_ok(last)
    assert last["correct"] is True, err
    assert last["attempted"] > 0 and last["failed"] == 0
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    assert set(last["metrics"]) == e2e and "setup_s" in e2e and len(e2e) >= 2
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_traced_run_reads_per_layer_metrics(checkout, cell):
    rc, last, err = drive(checkout, cell, trace=1)
    assert rc == 0, err
    _last_line_ok(last)
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    per_layer = {m["name"] for m in spec["per_layer"] if cell in m.get("workloads", [cell])}
    assert last["metrics"] and set(last["metrics"]) <= per_layer
    assert {"busy_s", "window_s"} <= set(last["device"])
    assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    # No device here: the kernels' rooflines and the idle share read nothing
    # and are left out rather than reported as 0.
    assert not any(k.endswith("_roofline") or k.startswith("device_idle")
                   for k in last["metrics"])


def test_new_cell_and_metric_are_found_by_name(checkout):
    """A cell and a per-layer metric added as files and entries run with no
    file of the harness edited."""
    cell = dict(TINY_CELLS["tiny.eval"], traffic={"batch": 2, "min_s": 1.0, "max_s": 1.0,
                                                  "pool": 1})
    (checkout / "benchmarks" / "workloads" / "tiny.eval.other.json").write_text(json.dumps(cell))
    (checkout / "benchmarks" / "metrics" / "tiny_batches.py").write_text(
        "def read(trace):\n    return trace.work.get('batches')\n")
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    spec["workloads"].append(tiny_entry("tiny.eval.other"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tiny.eval" in m.get("workloads", []):
            m["workloads"].append("tiny.eval.other")
    spec["per_layer"].append({"name": "tiny_batches", "unit": "count", "better": "higher",
                              "source": "program_counter", "layer": "decode loop",
                              "moves": "rtfx", "workloads": ["tiny.eval.other"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, last, err = drive(checkout, "tiny.eval.other", trace=1)
    assert rc == 0, err
    assert last["correct"] is True
    assert last["metrics"]["tiny_batches"]["value"] >= 1


def test_the_harness_refuses_to_run_without_the_card(checkout, monkeypatch):
    import torch

    from benchmarks import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "tiny.eval", "--seed", "1", "--seconds", "1"],
                    root=checkout) != 0


def test_import_check_compares_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "sar_tpu",
             "sar_tpu.models.whisper", "sar_tpu_torch", "sar_tpu_torch.ops.mel",
             "jaxtyping", "sar_tpu_torchvision", "numpy"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "sar_tpu",
        "sar_tpu.models.whisper"]
    assert harness.forbidden_modules(["sar_tpu_torch.models"]) == []


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    files = sorted((REPO / "benchmarks" / "reference").glob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & {"sar_tpu_torch", "sar_tpu", "jax", "jaxlib", "flax",
                                  "benchmarks"}, f


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for f in sorted((REPO / "benchmarks").rglob("*.py")):
        assert not _imports(f) & {"sar_tpu", "jax", "jaxlib", "flax"}, f


def test_open_loop_schedule_is_reproducible_and_seed_independent_in_load():
    a = arrivals.schedule(400, 16.0, 123456789012)
    b = arrivals.schedule(400, 16.0, 123456789012)
    c = arrivals.schedule(400, 16.0, 5)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # Every seed offers the same gaps in another order: the same last due.
    assert np.sort(np.diff(np.r_[0, a])) == pytest.approx(np.sort(np.diff(np.r_[0, c])))
    assert a[-1] == pytest.approx(c[-1])
    assert 400 / a[-1] == pytest.approx(16.0, rel=0.02)


def test_latency_counts_from_due_time_and_missing_requests_count_as_slowest():
    due = np.array([1.0, 1.5, 2.0, 2.5])
    done = np.array([1.2, 1.6, np.nan, 2.9])
    lat = arrivals.latencies_ms(due, done)
    assert lat[0] == pytest.approx(200.0) and lat[3] == pytest.approx(400.0)
    assert math.isinf(arrivals.percentile(lat, 95))
    assert arrivals.percentile(lat[[0, 1, 3]], 50) == pytest.approx(200.0)


def test_counts_reproduce_the_kernel_table_at_whisper_small_b8():
    """The old PERF.md kernel table's bounds at whisper-small, B=8: K1 55.3
    GFLOP, K2 339.7 GFLOP, K6 at 1500 x 1500 (dQ 6, dK/dV 8 operations per
    (q, k, d)). K3's 20.1 MB there counted the 1536 rows of the cache's
    layout tile; the 1500 valid rows need 19.6 MB."""
    k1_ops, _ = counts.k1(8, 12, 1500, 64)
    assert k1_ops / 1e9 == pytest.approx(55.3, abs=0.05)
    assert counts.bound_s(*counts.k1(8, 12, 1500, 64))[0] * 1e3 == pytest.approx(0.0559, abs=5e-5)
    k2_ops, k2_bytes = counts.k2(8, 1500, 768, 12, 12)
    assert k2_ops / 1e9 == pytest.approx(339.7, abs=0.05)
    assert counts.bound_s(k2_ops, k2_bytes) == (pytest.approx(0.3435e-3, abs=5e-8), "operations")
    _, k3_bytes = counts.k3(8, 1500, 768, 12)
    assert k3_bytes / 1e6 == pytest.approx(19.6, abs=0.05)
    assert counts.k3(8, 1536, 768, 12)[1] / 1e6 == pytest.approx(20.1, abs=0.05)
    assert counts.bound_s(*counts.k3(8, 1500, 768, 12))[1] == "bytes"
    k6 = counts.k6(8, 12, 1500, 1500, 64)
    assert [k6[p][0] / 1e9 for p in ("fwd", "dq", "dkv")] == pytest.approx(
        [55.3, 82.9, 110.6], abs=0.05)
    assert [counts.bound_s(*k6[p])[0] * 1e3 for p in ("dq", "dkv")] == pytest.approx(
        [0.0839, 0.1118], abs=5e-5)


def test_model_flops_follow_the_shapes():
    c = json.loads((REPO / "benchmarks" / "configs" / "whisper-small.json").read_text())
    enc = counts.encoder_flops(c, 1)
    # Two convolutions and 12 layers of 1500 frames: ~345 GFLOP per window.
    assert enc / 1e9 == pytest.approx(344.7, rel=0.01)
    dec = counts.decode_flops(c, 1, 4, 224)
    assert dec == pytest.approx(counts.decode_flops(c, 2, 4, 224) / 2)
    assert counts.decode_flops(c, 1, 4, 225) > dec


@pytest.mark.parametrize("cell,fault", [("tiny.eval", "token"), ("tiny.serve", "token"),
                                        ("tiny.serve", "route")])
def test_a_planted_fault_turns_correct_false(checkout, cell, fault):
    """The rest of a run, with the timed path broken underneath: a token
    altered where the decode loop produces it, or every request routed to
    the wrong adapter."""
    import torch
    c = harness.load_cell(cell, checkout)
    ctx = harness.Context(cell=c, seed=11, seconds=0.5, trace=False,
                          device=torch.device("cpu"), fault=fault)
    out = harness.load_driver(c.workload["driver"], checkout).run(ctx)
    out.release()
    checks = out.check()
    assert checks and not all(k["ok"] for k in checks), checks
