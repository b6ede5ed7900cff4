"""Cells of the benchmark cut to a size the CPU tests can hold: the same
files, kinds, backends and limits, fewer rows and iterations."""
from __future__ import annotations

import copy

from bench.harness import spec

TINY = {
    "knn": ({"n_train": 8000, "train_fragments": 4}, {"n_test": 800, "test_blocks": 4},
            {"rows": 64}),
    # clusters of some 20k points: one point that rounding sends to another
    # centroid moves a mean by far less than the step_gap limit
    "kmeans": ({"n_points": 320_000, "fragments": 4}, {"max_iters": 4}, {}),
}


def tiny_cell(name: str, backend: str = None) -> spec.Cell:
    cell = spec.load_cell(name)
    cell.config = dict(cell.config)
    cell.workload = copy.deepcopy(cell.workload)
    config, traffic, check = TINY[cell.kind]
    cell.config.update(config)
    cell.workload["traffic"].update(traffic)
    cell.workload["check"].update(check)
    if backend is not None:
        cell.workload["backend"] = backend
    return cell
