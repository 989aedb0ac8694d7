"""CPU tests of the OWSM cell's driver (drivers/eval_owsm.py) at owsm-test's
size (kernels and capture off), in a temporary checkout with a tiny OWSM
configuration and cell added as files: the untraced and traced runs print
the contract's line, `correct` holds, and a planted wrong token turns it
false. The readers of the E-Branchformer's spans read device time, which a
CPU run does not have: they are left out of its line."""

from __future__ import annotations

import json
import shutil

import pytest

from benchmarks.tests.conftest import REPO, drive

TINY_OWSM = {
    "name": "tiny_owsm", "source": "the port's owsm-test registry entry",
    "program_config": "owsm-test", "reduced": [],
    "d_model": 64, "encoder_layers": 2, "encoder_heads": 4, "decoder_layers": 2,
    "decoder_heads": 4, "ffn_dim": 128, "cgmlp_dim": 128, "cgmlp_kernel": 31,
    "merge_kernel": 7, "num_mel_bins": 80, "vocab_size": 256,
    "max_source_positions": 749, "max_target_positions": 32,
}


@pytest.fixture
def owsm_checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "benchmarks", root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "benchmarks" / "configs" / "tiny_owsm.json").write_text(json.dumps(TINY_OWSM))
    spec["configs"].append({"name": "tiny_owsm", "source": "owsm-test",
                            "file": "benchmarks/configs/tiny_owsm.json", "reduced": [],
                            "why": "tiny"})
    cell = json.loads((REPO / "benchmarks" / "workloads" / "owsm.eval.short.json").read_text())
    cell.update(config="tiny_owsm", max_new_tokens=6, flash="hm", capture=False,
                kernels=False, warmup_batches=1,
                traffic=dict(cell["traffic"], batch=3, pool=2, languages=["en", "hi", "te"]),
                check={"rows": 2, "max_logit_gap": 0.05})
    (root / "benchmarks" / "workloads" / "tiny.owsm.json").write_text(json.dumps(cell))
    spec["workloads"].append({"name": "tiny.owsm", "config": "tiny_owsm", "traffic": "owsm",
                              "chips": 1, "why": "tiny"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "owsm.eval.short" in m.get("workloads", []):
            m["workloads"].append("tiny.owsm")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_owsm_cell_prints_the_contract_line(owsm_checkout, trace):
    rc, last, err = drive(owsm_checkout, "tiny.owsm", seed=2**31 + 5, trace=trace)
    assert rc == 0, err
    assert last["correct"] is True and last["attempted"] > 0, err
    if trace:
        assert {"encode_ms", "decode_ms_per_step", "mfu.eval"} <= set(last["metrics"])
        assert not {"subsample_ms", "ebf_conv_ms"} & set(last["metrics"])
    else:
        assert set(last["metrics"]) == {"rtfx", "setup_s"}


def test_a_planted_wrong_token_is_not_correct(owsm_checkout):
    from benchmarks import control, harness
    import torch
    (seed, checks), = control.readings("tiny.owsm", [9], 0.5, torch.device("cpu"),
                                       fault="token", root=owsm_checkout)
    assert checks and not all(c["ok"] for c in checks)
    assert harness.load_cell("tiny.owsm", owsm_checkout).workload["driver"] == "eval_owsm"
