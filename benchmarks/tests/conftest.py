"""Fixtures of the harness's CPU tests: a copy of the benchmark in a
temporary checkout, with tiny cells at whisper-test's size added as files
(no file of the harness edited), and the runner that drives one run there
with the look for a card skipped."""

from __future__ import annotations

import io
import json
import shutil
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_CONFIG = {
    "name": "tiny", "source": "the port's whisper-test registry entry",
    "program_config": "whisper-test", "reduced": [],
    "d_model": 64, "encoder_layers": 2, "encoder_heads": 4, "decoder_layers": 2,
    "decoder_heads": 4, "ffn_dim": 128, "num_mel_bins": 80, "vocab_size": 256,
    "max_source_positions": 32, "max_target_positions": 32,
}

TINY_CELLS = {
    "tiny.eval": {
        "config": "tiny", "driver": "eval", "entry": "ASREvaluator.from_audio",
        "why": "tiny", "language": "hindi", "max_new_tokens": 6, "kv_int8": True,
        "flash": False, "capture": False, "kernels": False,
        "traffic": {"batch": 3, "min_s": 2.0, "max_s": 6.0, "pool": 2,
                    "languages": ["en", "hi", "te"]},
        "warmup_batches": 1, "check": {"rows": 2, "max_logit_gap": 0.05},
    },
    "tiny.serve": {
        "config": "tiny", "driver": "serve", "entry": "TranscriptionService.submit",
        "why": "tiny", "max_new_tokens": 5, "kernels": False, "capture": False,
        "lora": {"languages": ["hindi", "italian", "punjabi", "telugu"], "r": 4, "alpha": 8,
                 "target_modules": ["q_proj", "v_proj"], "encoder_hooks": ["q", "v"],
                 "decoder_hooks": ["self_q", "self_v", "cross_q", "cross_v"], "b_std": 0.05},
        "lid": {"layer": 0, "pooling": "mean", "hidden_dims": [16, 8]},
        "service": {"batch_size": 2, "max_wait_ms": 5},
        "traffic": {"rate_per_s": 8.0, "min_s": 0.2, "max_s": 0.6},
        "grace_s": 30, "profile_s": 0.3, "warmup_batches": 1,
        "check": {"rows": 2, "max_logit_gap": 0.05, "lid_logprob_gap": 0.05},
    },
}


def tiny_entry(name: str) -> dict:
    return {"name": name, "config": "tiny", "traffic": name.split(".", 1)[1], "chips": 1,
            "why": "tiny"}


@pytest.fixture
def checkout(tmp_path):
    """A temporary checkout: BENCHMARK.json and benchmarks/ copied, then the
    tiny configuration and cells added as new files and entries."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "benchmarks", root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "benchmarks" / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    spec["configs"].append({"name": "tiny", "source": "the port's whisper-test",
                            "file": "benchmarks/configs/tiny.json", "reduced": [], "why": "tiny"})
    drivers = {w["name"]: json.loads((REPO / "benchmarks" / "workloads" / f"{w['name']}.json")
                                     .read_text())["driver"] for w in spec["workloads"]}
    for name, cell in TINY_CELLS.items():
        (root / "benchmarks" / "workloads" / f"{name}.json").write_text(json.dumps(cell))
        spec["workloads"].append(tiny_entry(name))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and any(drivers.get(x) == cell["driver"] for x in m["workloads"]):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def drive(root: Path, cell: str, seed: int = 7, seconds: float = 0.5, trace: int = 0):
    """One run of `cell` in `root` on the CPU -> (exit code, parsed last
    line or None, stderr)."""
    from benchmarks import run
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], root=root, device="cpu")
    lines = out.getvalue().strip().splitlines()
    last = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, last, err.getvalue()


if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
