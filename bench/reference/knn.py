"""Plain reference of one ``run_knn`` pipeline, its control, and the
comparison that decides ``correct`` for the ``knn`` kind.

The reference regenerates the pipeline's training rows and the sampled
test rows from the seed (``bench/frozen/generators.py``), then finds each
sampled row's k nearest training rows over all fragments at once, in
float64 (or, for the control, in TF32), and takes the majority vote of
their labels (ties to the smallest class id, as ``KNN_classify``).  It
imports nothing of the program.

Numbers compared, each against the cell's limit:

* ``dist_gap``: the widest gap between the program's k squared distances
  of a sampled row, as its merge tree hands them to ``KNN_classify``, and
  the reference's, slot by slot in ascending order.  It holds the kernel
  (``knn_topk``), the fills and the merge tree.
* ``pred_mismatch``: the sampled rows whose prediction differs from the
  reference's, among the rows whose vote the distances decide: a row
  whose k-th and (k+1)-th nearest distances lie within twice the
  ``dist_gap`` limit of each other may swap them in a program that keeps
  that limit, and is left out.  It holds the vote (an exact comparison,
  limit 0).
"""
from __future__ import annotations

import numpy as np
import torch

from bench.frozen import generators as gen
from bench.harness.numerics import dtype_of, no_tf32, operand

CHUNK = 65_536     # training rows per product: 4096 sampled rows x CHUNK x 8 bytes


def reference(config: dict, traffic: dict, seed: int, rows: np.ndarray, device,
              precision: str = "float64") -> dict:
    """The k nearest training rows of the test rows at global indices
    ``rows`` of the pipeline seeded ``seed``: {"dists" (R, k) ascending,
    "labels" (R, k), "predictions" (R,), "margin" (R,): the (k+1)-th
    distance less the k-th}."""
    no_tf32()
    d, k, n_classes = config["d"], config["k"], config["n_classes"]
    X, y = gen.knn_training(seed, config["n_train"], d, n_classes, config["train_fragments"])
    T = gen.knn_test_rows(seed, traffic["n_test"], d, n_classes, traffic["test_blocks"],
                          np.asarray(rows))
    dt = dtype_of(precision)
    Xd = torch.from_numpy(X).to(device=device, dtype=dt)
    yd = torch.from_numpy(y).to(device)
    Td = torch.from_numpy(T).to(device=device, dtype=dt)
    del X, T
    t_op = operand(Td, precision)
    t2 = (Td * Td).sum(1)
    kk = k + 1
    best_d = best_i = None
    for start in range(0, Xd.shape[0], CHUNK):
        xc = Xd[start:start + CHUNK]
        d2 = (t2[:, None] - 2.0 * (t_op @ operand(xc, precision).T)) + (xc * xc).sum(1)[None]
        vals, idx = torch.topk(d2, min(kk, d2.shape[1]), dim=1, largest=False, sorted=True)
        idx = idx + start
        if best_d is not None:
            vals, pick = torch.topk(torch.cat([best_d, vals], 1), kk, dim=1, largest=False,
                                    sorted=True)
            idx = torch.gather(torch.cat([best_i, idx], 1), 1, pick)
        best_d, best_i = vals, idx
    margin = (best_d[:, k] - best_d[:, k - 1]).double().cpu().numpy()
    best_d, best_i = best_d[:, :k], best_i[:, :k]
    labels = yd[best_i]
    counts = torch.nn.functional.one_hot(labels, n_classes).sum(dim=1)
    preds = torch.argmax(counts, dim=1)
    return {"dists": best_d.double().cpu().numpy(), "labels": labels.cpu().numpy(),
            "predictions": preds.cpu().numpy(), "margin": margin}


def control(config: dict, traffic: dict, seed: int, rows: np.ndarray, device) -> dict:
    """The reference in TF32, in the program's place."""
    return reference(config, traffic, seed, rows, device, precision="tf32")


def compare(program: dict, ref: dict, limits: dict) -> dict:
    """The numbers compared: {"dist_gap": float, "pred_mismatch": int}."""
    pd = np.asarray(program["dists"], dtype=np.float64)
    rd = np.asarray(ref["dists"], dtype=np.float64)
    if pd.shape != rd.shape:
        return {"dist_gap": float("inf"), "pred_mismatch": int(len(ref["predictions"]))}
    gap = float(np.max(np.abs(pd - rd))) if pd.size else 0.0
    if not np.isfinite(gap):
        gap = float("inf")
    decided = np.asarray(ref["margin"]) > 2.0 * float(limits["dist_gap"])
    mismatch = int(np.sum((np.asarray(program["predictions"]) != ref["predictions"]) & decided))
    return {"dist_gap": gap, "pred_mismatch": mismatch}
