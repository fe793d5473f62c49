"""The benchmark on the card (marked ``cuda``; skipped without one): each
cell's control, the reference in fp8 in the program's place, comes out not
correct at the cell's own size, and so does the planted half-batch fault
of the training cell.  Run on an H100 with

    python -m pytest port_bench/tests/test_port_bench_chip.py -m cuda
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from port_bench import control  # noqa: E402
from port_bench.harness import core  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 3_300_000_001


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    from port_bench.reference.precision import float32_mode

    float32_mode()
    return torch.device("cuda")


def _over(cell, numbers) -> list:
    limits = core.load_json(HERE / "limits" / f"{cell}.json")
    return [k for k, v in limits.items() if numbers[k] > v]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct(cell, card):
    _, cfg, tr, _, _ = core.cell_spec(BENCH, cell)
    numbers = control.CONTROLS[tr["driver"]](cfg, tr, SEED, card)
    assert _over(cell, numbers), numbers


@pytest.mark.cuda
def test_train_half_batch_is_not_correct(card):
    _, cfg, tr, _, _ = core.cell_spec(BENCH, "resnet.train_b32")
    numbers = control.train_control(cfg, tr, SEED, card, fault="half_batch")
    assert _over("resnet.train_b32", numbers), numbers
