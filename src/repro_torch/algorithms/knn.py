"""Task-parallel K-Nearest-Neighbors classification (paper §4.1, Fig. 3):
the port of ``repro/algorithms/knn.py``.

DAG shape (faithful to the paper): ``KNN_fill_fragment`` tasks generate the
training fragments, ``KNN_frag`` tasks compute distances between a test
block and one training fragment and keep the local top-k, a tree of
``KNN_merge`` tasks combines the per-fragment candidate sets, and
``KNN_classify`` performs the majority vote.

What the port changes, and why:

* The fill tasks generate with NumPy exactly as the JAX package does (the
  same seeds give the same bits), then move the fragment to the device
  once, as fp32 rows and int32 labels.  Under the thread backend the
  object store then holds device tensors, and every later task reads
  them where they are; only the final predictions come back to the host.
* ``KNN_frag`` calls the fused distance + top-k kernel
  (:func:`repro_torch.kernels.ops.knn_topk`).  The reference's NumPy body
  never calls its Pallas twin; the port does on purpose — the kernel
  adaptation of DESIGN.md's design table, where intra-fragment
  parallelism moves into the kernel grid.
* ``KNN_merge`` keeps the first k of a stable sort (equal distances keep
  the earlier candidate), and ``KNN_classify`` counts votes with a one-hot
  sum; ``argmax`` returns the first maximum, the smallest class id.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core import api, collectives
from ..core.simulator import CostModel, SimTask
from ..kernels import ops
from .common import calibrate_cost, make_blobs, resolve_device, tree_reduce_spec


# --------------------------------------------------------------------- tasks
def knn_fill_fragment(seed: int, n: int, d: int, n_classes: int, device=None):
    """Generate one labelled training fragment on ``device``:
    (rows (n, d) fp32, labels (n,) int32)."""
    dev = resolve_device(device)
    X, y = make_blobs(seed, n, d, n_classes)
    return (torch.from_numpy(X.astype(np.float32)).to(dev),
            torch.from_numpy(y.astype(np.int32)).to(dev))


def knn_gen_test(seed: int, n: int, d: int, n_classes: int, device=None):
    X, _ = make_blobs(seed, n, d, n_classes)
    return torch.from_numpy(X.astype(np.float32)).to(resolve_device(device))


def knn_frag(frag, test_X: torch.Tensor, k: int):
    """Local k-NN of ``test_X`` against one training fragment.

    Returns (dists, labels): the k smallest distances per test point within
    this fragment, plus the labels of those neighbours.
    """
    train_X, train_y = frag
    return ops.knn_topk(test_X, train_X, train_y, k=min(k, train_X.shape[0]))


def knn_merge(a, b):
    """Merge two candidate sets, keeping the k best (k = width of inputs)."""
    da, la = a
    db, lb = b
    k = max(da.shape[1], db.shape[1])
    d = torch.cat([da, db], dim=1)
    lab = torch.cat([la, lb], dim=1)
    order = torch.sort(d, dim=1, stable=True).indices[:, :min(k, d.shape[1])]
    return torch.gather(d, 1, order), torch.gather(lab, 1, order)


def knn_classify(merged, n_classes: int):
    """Majority vote over the merged k nearest labels (ties -> smallest id)."""
    _, labels = merged
    counts = torch.nn.functional.one_hot(labels.long(), n_classes).sum(dim=1)
    return torch.argmax(counts, dim=1)


# -------------------------------------------------------------------- driver
@dataclass
class KNNResult:
    predictions: np.ndarray
    n_tasks: int


def run_knn(
    n_train: int = 2000,
    n_test: int = 2000,
    d: int = 50,
    k: int = 5,
    n_classes: int = 4,
    train_fragments: int = 4,
    test_blocks: int = 1,
    merge_arity: int = 2,
    seed: int = 0,
    device=None,
) -> KNNResult:
    """Sequential-style RCOMPSs program (requires a started runtime).
    ``device=None`` runs on CUDA and raises where there is none."""
    dev = resolve_device(device)
    fill_t = api.task(knn_fill_fragment, name="KNN_fill_fragment")
    gen_test_t = api.task(knn_gen_test, name="KNN_gen_test")
    frag_t = api.task(knn_frag, name="KNN_frag")
    merge_t = api.task(knn_merge, name="KNN_merge")
    classify_t = api.task(knn_classify, name="KNN_classify")

    frag_n = [n_train // train_fragments] * train_fragments
    frag_n[-1] += n_train - sum(frag_n)
    # fragment fan-outs use batched submission (DESIGN.md §14)
    frags = api.map_tasks(fill_t, [(seed + i, frag_n[i], d, n_classes, dev)
                                   for i in range(train_fragments)])

    blk_n = [n_test // test_blocks] * test_blocks
    blk_n[-1] += n_test - sum(blk_n)
    preds = []
    n_tasks = train_fragments
    for b in range(test_blocks):
        test_b = gen_test_t(10_000 + seed + b, blk_n[b], d, n_classes, dev)
        locals_ = api.map_tasks(frag_t, [(f, test_b, k) for f in frags])
        merged = collectives.tree_reduce(locals_, merge_t, arity=merge_arity)
        preds.append(classify_t(merged, n_classes))
        n_merges = len(collectives.reduce_spec(train_fragments, arity=merge_arity))
        n_tasks += 1 + train_fragments + n_merges + 1
    out = api.wait_on(preds)
    return KNNResult(np.concatenate([p.cpu().numpy() for p in out]), n_tasks)


# -------------------------------------------------------------------- oracle
def _np_knn_frag(frag, test_X: np.ndarray, k: int):
    train_X, train_y = frag
    d2 = (
        np.sum(test_X * test_X, axis=1)[:, None]
        - 2.0 * (test_X @ train_X.T)
        + np.sum(train_X * train_X, axis=1)[None, :]
    )
    kk = min(k, train_X.shape[0])
    idx = np.argpartition(d2, kk - 1, axis=1)[:, :kk]
    rows = np.arange(test_X.shape[0])[:, None]
    dists = d2[rows, idx]
    labels = train_y[idx]
    order = np.argsort(dists, axis=1, kind="stable")
    return dists[rows, order], labels[rows, order]


def _np_knn_classify(merged, n_classes: int):
    _, labels = merged
    counts = np.apply_along_axis(np.bincount, 1, labels, minlength=n_classes)
    return np.argmax(counts, axis=1)


def reference_knn(n_train, n_test, d, k, n_classes, train_fragments, test_blocks,
                  seed=0, merge_arity: int = 2):
    """Single-shot float64 NumPy oracle computing the same result as
    ``run_knn`` (same fragment seeds => identical data)."""
    frag_n = [n_train // train_fragments] * train_fragments
    frag_n[-1] += n_train - sum(frag_n)
    frags = [make_blobs(seed + i, frag_n[i], d, n_classes)
             for i in range(train_fragments)]
    X = np.concatenate([f[0] for f in frags])
    y = np.concatenate([f[1] for f in frags])

    blk_n = [n_test // test_blocks] * test_blocks
    blk_n[-1] += n_test - sum(blk_n)
    preds = []
    for b in range(test_blocks):
        test_b, _ = make_blobs(10_000 + seed + b, blk_n[b], d, n_classes)
        local = _np_knn_frag((X, y), test_b, k)
        preds.append(_np_knn_classify(local, n_classes))
    return np.concatenate(preds)


# --------------------------------------------------- simulator DAG generation
@dataclass
class KNNCosts:
    fill: CostModel
    frag: CostModel
    merge: CostModel
    classify: CostModel


def calibrate(d: int = 50, k: int = 5, n_classes: int = 4,
              units=(500, 1000, 2000), n_train_frag: int = 1000,
              device=None) -> KNNCosts:
    """Fit per-task cost models by timing the real task functions on
    ``device`` (CUDA unless ``device="cpu"``): each call is timed between
    two synchronisations of the card.  The fill tasks time as they run, a
    NumPy fill and then one host-to-device copy.  On the card, units that
    leave ``KNN_frag`` launch-bound make an affine fit that extrapolates
    to nothing: calibrate at the pipeline's own task sizes."""
    dev = resolve_device(device)
    frag = knn_fill_fragment(0, n_train_frag, d, n_classes, dev)

    def fill_u(u):
        return lambda: knn_fill_fragment(1, int(u), d, n_classes, dev)

    def frag_u(u):
        test = knn_gen_test(2, int(u), d, n_classes, dev)
        return lambda: knn_frag(frag, test, k)

    def merge_u(u):
        test = knn_gen_test(3, int(u), d, n_classes, dev)
        a = knn_frag(frag, test, k)
        return lambda: knn_merge(a, a)

    def classify_u(u):
        test = knn_gen_test(4, int(u), d, n_classes, dev)
        a = knn_frag(frag, test, k)
        return lambda: knn_classify(a, n_classes)

    return KNNCosts(
        fill=calibrate_cost(fill_u, units, "KNN_fill_fragment", device=dev),
        frag=calibrate_cost(frag_u, units, "KNN_frag", device=dev),
        merge=calibrate_cost(merge_u, units, "KNN_merge", device=dev),
        classify=calibrate_cost(classify_u, units, "KNN_classify", device=dev),
    )


def dag_spec(
    costs: KNNCosts,
    n_train: int,
    n_test: int,
    d: int,
    k: int,
    train_fragments: int,
    test_blocks: int,
    merge_arity: int = 2,
    calib_frag_rows: int = 1000,
) -> List[SimTask]:
    """Build the KNN DAG as SimTasks with calibrated durations.

    ``KNN_frag`` cost scales with (test rows × train-fragment rows) — the
    distance GEMM — normalized to the ``calib_frag_rows`` used during
    calibration; ``merge``/``classify`` scale with test-block rows; ``fill``
    with fragment rows.
    """
    tasks: List[SimTask] = []
    tid = 0
    frag_rows = n_train // train_fragments
    blk_rows = n_test // test_blocks
    frag_units = blk_rows * frag_rows / max(calib_frag_rows, 1)
    fbytes = frag_rows * d * 8
    fill_ids = []
    for _ in range(train_fragments):
        tasks.append(SimTask(tid, "KNN_fill_fragment", costs.fill(frag_rows), (),
                             out_bytes=fbytes))
        fill_ids.append(tid)
        tid += 1
    for _ in range(test_blocks):
        gen_id = tid
        tasks.append(SimTask(tid, "KNN_gen_test", costs.fill(blk_rows), (),
                             out_bytes=blk_rows * d * 8))
        tid += 1
        frag_ids = []
        for f in fill_ids:
            tasks.append(SimTask(tid, "KNN_frag", costs.frag(frag_units), (f, gen_id),
                                 out_bytes=blk_rows * k * 16))
            frag_ids.append(tid)
            tid += 1
        merges = tree_reduce_spec(len(frag_ids), arity=merge_arity)
        merge_ids = []
        for _, (a, b) in merges:
            da = frag_ids[a] if a < len(frag_ids) else merge_ids[a - len(frag_ids)]
            db = frag_ids[b] if b < len(frag_ids) else merge_ids[b - len(frag_ids)]
            tasks.append(SimTask(tid, "KNN_merge", costs.merge(blk_rows), (da, db),
                                 out_bytes=blk_rows * k * 16))
            merge_ids.append(tid)
            tid += 1
        last = merge_ids[-1] if merge_ids else frag_ids[-1]
        tasks.append(SimTask(tid, "KNN_classify", costs.classify(blk_rows), (last,),
                             out_bytes=blk_rows * 8))
        tid += 1
    return tasks
