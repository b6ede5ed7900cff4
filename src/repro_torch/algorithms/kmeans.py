"""Task-parallel K-means clustering (paper §4.2, Fig. 4): the port of
``repro/algorithms/kmeans.py``.

Per iteration: ``partial_sum`` tasks assign each fragment's points to the
nearest centroid and emit (per-cluster sums, counts, sse); a hierarchical
``merge`` tree combines them; ``update_centroids`` produces the new
centroids; the master checks convergence (the paper's ``converged``
function) — one synchronization per iteration, exactly as in Fig. 4.

What the port changes, and why:

* ``fill_fragment`` generates with NumPy exactly as the JAX package does
  and moves the fragment to the device once, as fp32.  The store then
  holds device tensors, so no iteration copies a fragment again.
* ``partial_sum`` calls the fused assignment + partial-sums kernel
  (:func:`repro_torch.kernels.ops.kmeans_assign`), which the reference's
  NumPy body never does — the kernel adaptation of DESIGN.md's design
  table.  It returns device tensors (sums fp32, counts int32, sse 0-d)
  and does not synchronise.
* ``merge`` adds on the device after widening to float64 / int64 (the
  NumPy partials are float64 / int64 too); ``update_centroids`` computes
  in float64 on the device and reads shift and sse back with one
  ``.item()`` each — the paper's per-iteration sync.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..core import api, collectives
from ..core.simulator import CostModel, SimTask
from ..kernels import ops
from .common import calibrate_cost, resolve_device, tree_reduce_spec


# --------------------------------------------------------------------- tasks
def _np_fill_fragment(seed: int, n: int, d: int, n_centers: int = 8,
                      spread: float = 5.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)) * spread
    which = rng.integers(0, n_centers, size=n)
    return (centers[which] + rng.standard_normal((n, d))).astype(np.float64)


def fill_fragment(seed: int, n: int, d: int, n_centers: int = 8,
                  spread: float = 5.0, device=None) -> torch.Tensor:
    """One fragment of points, (n, d) fp32 on ``device``."""
    X = _np_fill_fragment(seed, n, d, n_centers, spread)
    return torch.from_numpy(X.astype(np.float32)).to(resolve_device(device))


def partial_sum(X: torch.Tensor, centroids: torch.Tensor):
    """Assign points to nearest centroid; return (sums, counts, sse)."""
    c = centroids.to(device=X.device, dtype=torch.float32)
    return ops.kmeans_assign(X, c)


def merge(a, b):
    return (a[0].double() + b[0].double(), a[1].long() + b[1].long(),
            a[2].double() + b[2].double())


def update_centroids(acc, old_centroids: torch.Tensor):
    sums, counts, sse = acc
    counts = counts.long()
    new = sums.double() / counts.clamp(min=1)[:, None]
    # keep empty clusters in place
    new = torch.where((counts == 0)[:, None], old_centroids, new)
    shift = torch.linalg.vector_norm(new - old_centroids, dim=1).max().item()
    return new, shift, sse.item()


# -------------------------------------------------------------------- driver
@dataclass
class KMeansResult:
    centroids: np.ndarray
    iterations: int
    sse: float
    shifts: List[float]
    # the sse of every iteration, in order (the last equals ``sse``)
    sse_history: List[float] = field(default_factory=list)


def run_kmeans(
    n_points: int = 20_000,
    d: int = 10,
    k: int = 8,
    fragments: int = 4,
    max_iters: int = 10,
    tol: float = 1e-4,
    merge_arity: int = 2,
    seed: int = 0,
    device=None,
) -> KMeansResult:
    """Sequential-style RCOMPSs program (requires a started runtime).
    ``device=None`` runs on CUDA and raises where there is none."""
    dev = resolve_device(device)
    fill_t = api.task(fill_fragment, name="fill_fragment")
    psum_t = api.task(partial_sum, name="partial_sum")
    merge_t = api.task(merge, name="merge")
    upd_t = api.task(update_centroids, name="update_centroids")

    frag_n = [n_points // fragments] * fragments
    frag_n[-1] += n_points - sum(frag_n)
    # fan-out loops go through map_tasks: one batched submission instead
    # of per-task graph/inflight locking (DESIGN.md §14)
    frags = api.map_tasks(fill_t, [(seed + i, frag_n[i], d, 8, 5.0, dev)
                                   for i in range(fragments)])

    rng = np.random.default_rng(seed)
    centroids = torch.from_numpy(rng.standard_normal((k, d)) * 5.0).to(dev)
    shifts: List[float] = []
    sses: List[float] = []
    sse = float("inf")
    it = 0
    for it in range(1, max_iters + 1):
        partials = api.map_tasks(psum_t, [(f, centroids) for f in frags])
        acc = collectives.tree_reduce(partials, merge_t, arity=merge_arity)
        res = upd_t(acc, centroids)
        centroids, shift, sse = api.wait_on(res)  # per-iteration sync (Fig. 4)
        shifts.append(shift)
        sses.append(sse)
        if shift < tol:  # the paper's `converged` check
            break
    return KMeansResult(centroids.cpu().numpy(), it, sse, shifts, sses)


# -------------------------------------------------------------------- oracle
def _np_partial_sum(X: np.ndarray, centroids: np.ndarray):
    d2 = (
        np.sum(X * X, axis=1)[:, None]
        - 2.0 * (X @ centroids.T)
        + np.sum(centroids * centroids, axis=1)[None, :]
    )
    assign = np.argmin(d2, axis=1)
    k = centroids.shape[0]
    counts = np.bincount(assign, minlength=k).astype(np.int64)
    sums = np.zeros_like(centroids)
    np.add.at(sums, assign, X)
    sse = float(np.sum(d2[np.arange(X.shape[0]), assign]))
    return sums, counts, sse


def _np_update_centroids(acc, old_centroids: np.ndarray):
    sums, counts, sse = acc
    safe = np.maximum(counts, 1)[:, None]
    new = sums / safe
    empty = counts == 0
    new[empty] = old_centroids[empty]  # keep empty clusters in place
    shift = float(np.max(np.linalg.norm(new - old_centroids, axis=1)))
    return new, shift, sse


def reference_kmeans(n_points, d, k, fragments, max_iters, tol, seed=0):
    """Single-shot float64 NumPy oracle: same fragments, same centroid
    init, same update rule as ``run_kmeans``."""
    frag_n = [n_points // fragments] * fragments
    frag_n[-1] += n_points - sum(frag_n)
    X = np.concatenate([_np_fill_fragment(seed + i, frag_n[i], d)
                        for i in range(fragments)])
    rng = np.random.default_rng(seed)
    centroids = rng.standard_normal((k, d)) * 5.0
    it = 0
    sse = float("inf")
    for it in range(1, max_iters + 1):
        acc = _np_partial_sum(X, centroids)
        centroids, shift, sse = _np_update_centroids(acc, centroids)
        if shift < tol:
            break
    return centroids, it, sse


# --------------------------------------------------- simulator DAG generation
@dataclass
class KMeansCosts:
    fill: CostModel
    psum: CostModel
    merge: CostModel
    update: CostModel


def calibrate(d: int = 50, k: int = 8, units=(2000, 8000, 16000),
              device=None) -> KMeansCosts:
    """Fit per-task cost models by timing the real task functions on
    ``device`` (CUDA unless ``device="cpu"``; each call timed between two
    synchronisations of the card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    cents = torch.from_numpy(rng.standard_normal((k, d))).to(dev)

    def fill_u(u):
        return lambda: fill_fragment(1, int(u), d, device=dev)

    def psum_u(u):
        X = fill_fragment(2, int(u), d, device=dev)
        return lambda: partial_sum(X, cents)

    def merge_u(u):
        X = fill_fragment(3, max(int(u) // 8, 64), d, device=dev)
        a = partial_sum(X, cents)
        return lambda: merge(a, a)

    def update_u(u):
        X = fill_fragment(4, max(int(u) // 8, 64), d, device=dev)
        a = partial_sum(X, cents)
        return lambda: update_centroids(a, cents)

    return KMeansCosts(
        fill=calibrate_cost(fill_u, units, "fill_fragment", device=dev),
        psum=calibrate_cost(psum_u, units, "partial_sum", device=dev),
        merge=calibrate_cost(merge_u, units, "merge", device=dev),
        update=calibrate_cost(update_u, units, "update_centroids", device=dev),
    )


def dag_spec(
    costs: KMeansCosts,
    n_points: int,
    d: int,
    k: int,
    fragments: int,
    iterations: int,
    merge_arity: int = 2,
) -> List[SimTask]:
    tasks: List[SimTask] = []
    tid = 0
    rows = n_points // fragments
    fbytes = rows * d * 8
    cbytes = k * d * 8 + k * 8
    fill_ids = []
    for _ in range(fragments):
        tasks.append(SimTask(tid, "fill_fragment", costs.fill(rows), (), out_bytes=fbytes))
        fill_ids.append(tid)
        tid += 1
    prev_update = None
    for _ in range(iterations):
        psum_ids = []
        for f in fill_ids:
            deps = (f,) if prev_update is None else (f, prev_update)
            tasks.append(SimTask(tid, "partial_sum", costs.psum(rows), deps,
                                 out_bytes=cbytes))
            psum_ids.append(tid)
            tid += 1
        merges = tree_reduce_spec(len(psum_ids), arity=merge_arity)
        merge_ids = []
        for _, (a, b) in merges:
            da = psum_ids[a] if a < len(psum_ids) else merge_ids[a - len(psum_ids)]
            db = psum_ids[b] if b < len(psum_ids) else merge_ids[b - len(psum_ids)]
            tasks.append(SimTask(tid, "merge", costs.merge(rows), (da, db),
                                 out_bytes=cbytes))
            merge_ids.append(tid)
            tid += 1
        last = merge_ids[-1] if merge_ids else psum_ids[-1]
        tasks.append(SimTask(tid, "update_centroids", costs.update(rows), (last,),
                             out_bytes=cbytes))
        prev_update = tid
        tid += 1
    return tasks
