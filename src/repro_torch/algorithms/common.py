"""Shared helpers for the task-parallel algorithms (copied from the JAX
package), and the bridge from measured task times to the simulator.

The port's task bodies launch kernels asynchronously on the current
stream, so a host clock around a call on the card reads the launch (about
10 µs), not the task: :func:`timeit_median` brackets each call with
``torch.cuda.synchronize`` when it is given a CUDA device.

The fills take one path on every device: the host draws what is small
(labels, centres, beta) in a ``generate`` span, :func:`upload` moves it
to the device in an ``upload`` span, and ``ops.normal_fill`` draws the
O(n·d) normals in a second ``generate`` span (:func:`blobs`), NumPy's
own stream: with NumPy on the CPU, with the kernel on the card, so the
same seeds give the same data on both."""
from __future__ import annotations

import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..core import tracing
from ..core.simulator import CostModel
from ..kernels import ops


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


def upload(arrays, device: torch.device) -> List[torch.Tensor]:
    """Small host arrays (a fill's labels, centres, beta) on ``device``.  To
    a CUDA device they are copied asynchronously from pinned memory on the
    current stream: a copy from pageable memory would wait for every
    kernel queued there.  On the CPU they stay where they are
    (``pin_memory`` needs CUDA)."""
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if device.type != "cuda":
        return tensors
    return [t.pin_memory().to(device, non_blocking=True) for t in tensors]


def blobs(rng: np.random.Generator, centers: np.ndarray, labels: np.ndarray,
          device: torch.device):
    """``(centers[labels] + rng.standard_normal((n, d))).astype(np.float32)``
    on ``device``, the normals drawn from ``rng``'s state (which stays
    where it is) by ``ops.normal_fill``: the host's bytes.  The centres
    and the int32 labels go to the device first (the ``upload`` span),
    then the rows are filled (a ``generate`` span).  Returns (rows (n, d)
    fp32, labels (n,) int32) on ``device``."""
    with tracing.span("upload"):
        cents, labs = upload([centers, labels.astype(np.int32)], device)
    with tracing.span("generate"):
        X = torch.empty((labels.shape[0], centers.shape[1]), dtype=torch.float32, device=device)
        ops.normal_fill(rng.bit_generator.state, X, centres=cents, labels=labs)
    return X, labs


def _synchronize(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timeit_median(fn: Callable, repeats: int = 3, device=None) -> float:
    """Median seconds of ``repeats`` calls of ``fn``.  On a CUDA
    ``device`` each call is timed between two synchronisations of that
    device, so the time covers the work the call queued; on the CPU (or
    with no device) it is the plain wall clock."""
    ts = []
    for _ in range(repeats):
        _synchronize(device)
        t0 = time.perf_counter()
        fn()
        _synchronize(device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def calibrate_cost(fn_of_units: Callable[[int], Callable], units: Sequence[int],
                   name: str = "", repeats: int = 3, device=None) -> CostModel:
    """Measure ``fn_of_units(u)()`` for each u and fit an affine CostModel —
    the bridge between real execution and the scaling simulator.  The
    samples stay on the model (``samples``: ``(units, seconds)`` pairs) so
    a caller can read the fit's residuals."""
    samples = []
    for u in units:
        call = fn_of_units(u)
        samples.append((float(u), timeit_median(call, repeats=repeats, device=device)))
    model = CostModel.fit(samples, name=name)
    model.samples = samples
    return model


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
