"""Shared helpers for the task-parallel algorithms (copied from the JAX
package; ``calibrate_cost`` comes with the simulator in a later slice)."""
from __future__ import annotations

import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch


def tree_reduce(items: Sequence, merge_task: Callable, arity: int = 2):
    """Hierarchical reduction through ``merge_task`` calls — the paper's
    ``*_merge`` task trees (Figs. 3-5).  Works on Futures (submits merge
    tasks) or on plain values (if ``merge_task`` is a plain function).

    The reduction executes exactly the schedule :func:`tree_reduce_spec`
    emits, so the live DAG and the simulator's shape are isomorphic by
    construction: every arity group merges as a balanced sub-tree and the
    whole reduction has depth ⌈log_arity(n)⌉ groups deep."""
    items = list(items)
    if not items:
        raise ValueError("tree_reduce of empty sequence")
    if arity < 2:
        raise ValueError(f"tree_reduce arity must be >= 2, got {arity}")
    vals = list(items)
    for _, (a, b) in tree_reduce_spec(len(items), arity):
        vals.append(merge_task(vals[a], vals[b]))
    return vals[-1]


def tree_reduce_spec(n_leaves: int, arity: int = 2) -> List[Tuple[int, Tuple[int, ...]]]:
    """Shape-only version for DAG generation: returns merge nodes as
    (merge_index, (child_a, child_b)) where children < n_leaves are leaves and
    children >= n_leaves refer to merge node ``child - n_leaves``.

    Merges are emitted in dependency order: a merge only references leaves
    or merges that appear earlier in the list.  Each arity group reduces by
    repeated pairwise halving (a balanced binary sub-tree), never by a
    serial left fold, so the critical path through a group of g leaves is
    ⌈log2(g)⌉ merges rather than g-1."""
    if arity < 2:
        raise ValueError(f"tree_reduce arity must be >= 2, got {arity}")
    ids = list(range(n_leaves))
    merges: List[Tuple[int, Tuple[int, ...]]] = []
    next_id = n_leaves
    while len(ids) > 1:
        nxt = []
        for i in range(0, len(ids), arity):
            group = ids[i : i + arity]
            while len(group) > 1:
                paired = []
                for j in range(0, len(group) - 1, 2):
                    merges.append((next_id - n_leaves, (group[j], group[j + 1])))
                    paired.append(next_id)
                    next_id += 1
                if len(group) % 2:
                    paired.append(group[-1])
                group = paired
            nxt.append(group[0])
        ids = nxt
    return merges


def make_blobs(seed: int, n: int, d: int, n_classes: int, spread: float = 4.0):
    """Synthetic labelled clusters (the paper generates data on the fly in
    ``*_fill_fragment`` tasks rather than reading files)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, size=n)
    centers = rng.standard_normal((n_classes, d)) * spread
    X = centers[y] + rng.standard_normal((n, d))
    return X.astype(np.float64), y.astype(np.int64)


def timeit_median(fn: Callable, repeats: int = 3) -> float:
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def resolve_device(device=None) -> torch.device:
    """The device a pipeline runs on: ``None`` means ``"cuda"``.  Asking
    for CUDA where there is none raises — nothing falls back to the CPU
    unless the caller passed ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the pipeline "
            "on the CPU with the kernels' plain versions")
    return dev
