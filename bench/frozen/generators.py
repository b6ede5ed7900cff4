"""Frozen copies of the pipelines' data generators and partition rules.

The benchmark's reference regenerates each pipeline's data from its seed
with these copies, so that it takes nothing from the program under test.
They are copied from ``src/repro_torch/algorithms/common.py``
(``make_blobs``) and ``src/repro_torch/algorithms/kmeans.py``
(``_np_fill_fragment``, the centroid initialisation and the fragment
split of ``run_kmeans``; the fragment and block splits and seed offsets
of ``run_knn`` in ``knn.py``) at commit 6a9b660.  They stay frozen: a
program that changes its generators no longer computes what these
produce, and the benchmark says so by failing its check.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

# run_knn: the test block b of a pipeline seeded s is generated from
# seed TEST_SEED_OFFSET + s + b, its training fragment i from s + i
TEST_SEED_OFFSET = 10_000


def make_blobs(seed: int, n: int, d: int, n_classes: int, spread: float = 4.0):
    """Labelled Gaussian blobs: ``algorithms/common.make_blobs``."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, size=n)
    centers = rng.standard_normal((n_classes, d)) * spread
    X = centers[y] + rng.standard_normal((n, d))
    return X.astype(np.float64), y.astype(np.int64)


def kmeans_fragment(seed: int, n: int, d: int, n_centers: int = 8,
                    spread: float = 5.0) -> np.ndarray:
    """One K-means fragment: ``algorithms/kmeans._np_fill_fragment``."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)) * spread
    which = rng.integers(0, n_centers, size=n)
    return (centers[which] + rng.standard_normal((n, d))).astype(np.float64)


def kmeans_initial_centroids(seed: int, k: int, d: int) -> np.ndarray:
    """``run_kmeans``'s first centroids: ``rng(seed).standard_normal * 5``."""
    return np.random.default_rng(seed).standard_normal((k, d)) * 5.0


def split(total: int, parts: int) -> List[int]:
    """Rows per fragment or block: equal parts, the remainder on the last
    (``run_knn`` and ``run_kmeans`` both split so)."""
    sizes = [total // parts] * parts
    sizes[-1] += total - sum(sizes)
    return sizes


def in_threads(fn, args: Sequence[tuple], threads: int = 4) -> list:
    """``[fn(*a) for a in args]`` over a few threads: NumPy's generators
    release the interpreter lock while they fill large arrays."""
    with ThreadPoolExecutor(max_workers=threads) as pool:
        return list(pool.map(lambda a: fn(*a), args))


def knn_training(seed: int, n_train: int, d: int, n_classes: int,
                 fragments: int) -> Tuple[np.ndarray, np.ndarray]:
    """All training rows and labels of one ``run_knn`` pipeline, in
    fragment order."""
    sizes = split(n_train, fragments)
    parts = in_threads(make_blobs, [(seed + i, sizes[i], d, n_classes)
                                    for i in range(fragments)])
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])


def knn_test_rows(seed: int, n_test: int, d: int, n_classes: int, blocks: int,
                  rows: np.ndarray) -> np.ndarray:
    """The test rows at global indices ``rows`` (sorted) of one
    ``run_knn`` pipeline: each block that holds one is regenerated."""
    sizes = split(n_test, blocks)
    starts = np.cumsum([0] + sizes[:-1])
    which = np.searchsorted(starts, rows, side="right") - 1
    need = sorted(set(int(b) for b in which))
    blocks_x = dict(zip(need, in_threads(
        lambda b: make_blobs(TEST_SEED_OFFSET + seed + b, sizes[b], d, n_classes)[0],
        [(b,) for b in need])))
    return np.stack([blocks_x[int(b)][int(r - starts[b])] for r, b in zip(rows, which)])


def kmeans_points(seed: int, n_points: int, d: int, fragments: int,
                  n_centers: int = 8, spread: float = 5.0) -> np.ndarray:
    """All points of one ``run_kmeans`` pipeline, in fragment order."""
    sizes = split(n_points, fragments)
    parts = in_threads(kmeans_fragment, [(seed + i, sizes[i], d, n_centers, spread)
                                         for i in range(fragments)])
    return np.concatenate(parts)
