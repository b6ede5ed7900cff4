"""The control of each cell's check comes out not correct: the plain
reference computed with TF32 products, put in the program's place, fails
one of the cell's limits.  On the CPU at a small size; the ``gpu`` case
runs it at the cell's own size on the card (``bench/control.py`` does
the same from the command line, over several seeds)."""
from __future__ import annotations

import pytest

from bench.control import control_readings
from bench.harness import spec
from bench.tests.tiny import tiny_cell

CELLS = ["knn_d50.bulk", "knn_d50.paper", "kmeans_d50.paper"]


def small_cell(name):
    cell = tiny_cell(name)
    if cell.kind == "knn":
        cell.config.update(n_train=40_000)
        cell.workload["check"]["rows"] = 512
    else:
        cell.workload["traffic"]["max_iters"] = 10
    return cell


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 11, 12])
def test_the_control_fails_the_check_at_a_small_size(name, seed):
    pytest.importorskip("torch")
    out = control_readings(small_cell(name), seed, "cpu")
    assert not out["passed"], out["numbers"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_check_at_the_cells_size_on_the_card(name):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = control_readings(spec.load_cell(name), 2 ** 31 + 21, torch.device("cuda"))
    assert not out["passed"], out["numbers"]
