"""On a card (marked `cuda`, skipped without one): each cell at its own
size, one seed, the program's readings within the cell's limits and the
control's past one of them. Run on the card's machine with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        benchmark/tests/test_bench_chip.py
"""

import json

import pytest
import torch

from benchmark import readings
from benchmark.harness import cell as C
from benchmark.harness import probe

SPEC = json.loads((C.ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]
                                  if w["chips"] == 1])
def test_cell_program_within_and_control_past_its_limits(card, name):
    cell = C.Cell(name)
    rec = C.run(cell, 2 ** 31 + 99, 2.0, False, card, probe.Spans())
    limits = cell.workload["limits"]
    assert all(c["value"] <= c["limit"] for c in rec["checks"].values())
    got = (readings.training_readings if cell.workload["kind"] == "train"
           else readings.serving_readings)(cell, rec)["control"]
    assert any(got[k] > limits[k] for k in limits), (got, limits)
