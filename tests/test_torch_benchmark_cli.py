"""The port's benchmark CLI (sar_tpu_torch/scripts/benchmark.py) on the
CPU at whisper-test: tests/test_benchmark_cli.py's eight cases run with
--device cpu (the numbers mean nothing off the card; these guard the
rows and their plumbing), the port's rows holding JAX's row keys (JAX's
benchmark.main on the same arguments: a greedy row, a beam row, the
routed row and two streaming rows; the port adds only its per-iteration
walls, `iter_s`, to the first three), the
bf16 and classic-layout rows, and the flags it refuses."""

import sys
from pathlib import Path

import pytest

import _torch_port  # noqa: F401  (one torch thread per worker)
from sar_tpu_torch.scripts import benchmark

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

CPU = ["--model", "whisper-test", "--device", "cpu"]


def run(*extra):
    return benchmark.main([*CPU, *extra])


def test_benchmark_greedy_and_beam_rows():
    report = run("--batch_sizes", "2", "--max_new_tokens", "4", "--num_beams", "1", "2",
                 "--iters", "1")
    rows = report["results"]
    assert [r["num_beams"] for r in rows] == [1, 2]
    assert all(r["rtfx"] > 0 and len(r["iter_s"]) == 1 for r in rows)
    # The int8 greedy row decodes over the head-minor slabs and compares
    # with the classic layout (identical tokens on the CPU's plain paths).
    assert rows[0]["layout"] == "head_minor"
    assert rows[0]["token_agreement_vs_classic"] == 1.0


def test_benchmark_int4_kv_row():
    (row,) = run("--batch_sizes", "2", "--max_new_tokens", "4", "--kv_cache", "int4",
                 "--iters", "1")["results"]
    assert row["kv"] == "int4" and row["rtfx"] > 0
    assert 0.0 <= row["token_agreement_vs_int8"] <= 1.0


def test_benchmark_no_agreement_skips_comparison_decode():
    (row,) = run("--batch_sizes", "2", "--max_new_tokens", "4", "--kv_cache", "int4",
                 "--iters", "1", "--no_agreement")["results"]
    assert row["kv"] == "int4" and row["rtfx"] > 0
    assert "token_agreement_vs_int8" not in row


def test_benchmark_scores_int8_row_reports_agreement():
    (row,) = run("--batch_sizes", "2", "--max_new_tokens", "4", "--attn_scores", "int8",
                 "--iters", "1")["results"]
    assert row["attn_scores"] == "int8"
    assert 0.0 <= row["token_agreement_vs_bf16"] <= 1.0


def test_benchmark_serving_row():
    (row,) = run("--batch_sizes", "2", "--max_new_tokens", "6", "--serving",
                 "--serving_requests", "5", "--serving_wait_ms", "100")["results"]
    assert row["mode"] == "serving"
    assert row["requests"] == 5
    assert row["requests_per_s"] > 0
    assert row["batches"] >= 3          # 5 requests at batch 2
    assert row["latency_ms_p50"] > 0


def test_benchmark_train_row():
    (row,) = run("--batch_sizes", "2", "--train", "--train_accum", "2",
                 "--train_label_len", "8", "--train_lora_rank", "4", "--iters", "1")["results"]
    assert row["mode"] == "train"
    assert row["batch"] == 2 and row["accum"] == 2
    assert row["examples_per_s"] > 0


def test_benchmark_routed_row():
    """Routing may cost time, never tokens."""
    (row,) = run("--batch_sizes", "2", "--max_new_tokens", "4", "--routed",
                 "--routed_languages", "2", "--routed_lora_rank", "4",
                 "--iters", "1")["results"]
    assert row["mode"] == "routed"
    assert row["languages"] == 2
    assert row["rtfx_routed"] > 0 and row["rtfx_oracle"] > 0
    assert row["token_agreement_vs_oracle"] == 1.0
    assert row["lid_ms_per_utt"] > 0


def test_benchmark_routed_early_lid_tap():
    (row,) = run("--batch_sizes", "2", "--max_new_tokens", "4", "--routed",
                 "--routed_languages", "2", "--routed_lora_rank", "4",
                 "--routed_lid_layer", "0", "--iters", "1")["results"]
    assert row["lid_layer"] == 0
    assert row["token_agreement_vs_oracle"] == 1.0


def test_benchmark_bf16_and_classic_rows(tmp_path):
    """The unquantized cache (kv bf16) and the classic int8 layout; --output
    writes the report."""
    out = tmp_path / "report.json"
    report = run("--batch_sizes", "2", "--max_new_tokens", "4", "--kv_cache", "bf16",
                 "int8", "--kv_layout", "classic", "--iters", "2", "--output", str(out))
    bf16, classic = report["results"]
    assert (bf16["kv"], bf16["layout"]) == ("bf16", "classic")
    assert (classic["kv"], classic["layout"]) == ("int8", "classic")
    assert all(len(r["iter_s"]) == 2 and "error" not in r for r in (bf16, classic))
    assert "token_agreement_vs_classic" not in classic
    assert out.read_text().startswith("{")


@pytest.mark.parametrize("extra", [
    ["--batch_sizes", "2", "--max_new_tokens", "4", "--num_beams", "1", "2",
     "--kv_layout", "classic"],
    ["--batch_sizes", "2", "--max_new_tokens", "4", "--routed", "--routed_languages", "2",
     "--routed_lora_rank", "4", "--routed_lid_layer", "0"],
    ["--max_new_tokens", "4", "--streaming", "--streaming_chunk_seconds", "0.2",
     "--kv_cache", "int8", "bf16"],
])
def test_rows_carry_jax_keys(extra):
    """JAX's benchmark.main and the port's on the same arguments give rows
    with the same keys, the port's `iter_s` aside."""
    import benchmark as jax_benchmark
    want = jax_benchmark.main(["--model", "whisper-test", "--platform", "cpu",
                               "--iters", "1", *extra])
    got = run("--iters", "1", *extra)
    assert set(got) - {"peak_mem_gb"} == set(want)
    assert len(got["results"]) == len(want["results"])
    for g, w in zip(got["results"], want["results"]):
        assert set(g) - {"iter_s"} == set(w)
        assert {k: g[k] for k in ("batch", "mode", "num_beams", "kv", "lid_layer")
                if k in w} == {k: w[k] for k in ("batch", "mode", "num_beams", "kv",
                                                 "lid_layer") if k in w}
    import jax
    jax.clear_caches()


@pytest.mark.parametrize("extra", [["--dp", "2"], ["--platform", "tpu"]])
def test_refused_flags(extra, capsys):
    """--platform is refused at parsing; a mesh flag is ported and, in one
    process, exits naming the devices it needs."""
    if extra[0] == "--dp":
        with pytest.raises(SystemExit, match="--dp 2 x --tp 1 needs 2 devices"):
            benchmark.main([*CPU, *extra])
        return
    with pytest.raises(SystemExit):
        benchmark.parse_args([*CPU, *extra])
    assert "not ported to sar_tpu_torch" in capsys.readouterr().err


def test_profiling_helpers(tmp_path):
    """utils/profiling.py on the CPU: the timers count each iteration, rtfx
    is audio over the mean wall, force passes its argument through, and
    trace writes a Chrome trace holding the profiled op."""
    import json as _json

    import torch

    from sar_tpu_torch.utils import profiling
    x = torch.ones(64, 64)
    stats = profiling.benchmark_fn(torch.matmul, x, x, iters=3)
    assert stats["iters"] == 3 and len(stats["iter_s"]) == 3
    assert stats["per_iter_s"] == pytest.approx(stats["total_s"] / 3)
    assert profiling.rtfx(torch.matmul, x, x, audio_seconds=30.0, iters=2) > 0
    assert profiling.force({"a": [x]}) == {"a": [x]}
    with profiling.Timer() as timer:
        torch.matmul(x, x)
    assert timer.elapsed > 0
    with profiling.trace(tmp_path / "tr") as prof:
        torch.matmul(x, x)
    assert prof is not None
    events = _json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)
