"""On the card (marked cuda; skipped elsewhere, decided in the test): every
cell of BENCHMARK.json runs correct for a short window, and under its
configuration's control (the program's reduced-precision twin) comes out
not correct, at the cell's own size and load.

    python -m pytest -p no:cacheprovider portbench/tests/test_portbench_cuda.py

(from the checkout's root: pytest reads this folder's conftest.py, which
imports no JAX, and not the one under tests/.)"""

import time

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("control", [False, True])
def test_cell_on_the_card(cuda, cell, control):
    out = harness.run(BENCH, harness.find_cell(BENCH, cell), 12345, 4.0,
                      False, cuda, time.perf_counter(), control=control)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["correct"] is not control, out["checks"]
