"""The control of each cell's `correct`, on the card at the cell's own
size: the plain reference at float8 e4m3 in the program's place must fail
one of the cell's numbers on three seeds, while the program's own run
passes them all. Skips without a card.

    python3 -m pytest benchmarks/tests/test_bench_control_cuda.py -m cuda -q
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmarks import control, harness

pytestmark = pytest.mark.cuda

SEEDS = (4100000001, 4100000002, 4100000003)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("the control runs the cells at their own size on the card")
    return torch.device("cuda", 0)


def _cells() -> list[str]:
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in spec["workloads"]]


@pytest.mark.parametrize("cell", _cells())
def test_the_control_fails_and_the_program_passes(dev, cell):
    for seed, checks in control.readings(cell, SEEDS, 2.0, dev):
        print(json.dumps({"cell": cell, "seed": seed, "checks": checks}))
        program = [k for k in checks if not k["name"].startswith("control_")]
        ctl = [k for k in checks if k["name"].startswith("control_")]
        assert program and all(k["ok"] for k in program), checks
        assert ctl and not all(k["ok"] for k in ctl), checks
