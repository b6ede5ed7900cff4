"""Task-parallel linear regression with prediction (paper §4.3, Fig. 5):
the port of ``repro/algorithms/linreg.py``.

Nine task types, mirroring the paper's DAG: ``LR_fill_fragment`` generates
(X, y) fragments; ``partial_ztz`` computes each fragment's Gram contribution
X'X (intercept column included); ``partial_zty`` computes X'y; two merge
trees combine them; ``compute_model_parameters`` solves the normal
equations; ``LR_genpred`` generates prediction inputs; ``compute_prediction``
applies the model; the final sync closes the pipeline.

What the port changes: the generators run NumPy exactly as the JAX
package does and move the data to the device once, in float64; the Gram
products are plain float64 GEMMs (``torch.matmul``) — the reference
leaves them to BLAS outside any Pallas kernel, so no kernel is owed —
and the fit is ``torch.linalg.solve``.  Only beta and the predictions
come back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core import api, collectives
from ..core.simulator import CostModel, SimTask
from .common import calibrate_cost, resolve_device

# default k-ary width of the collective merge trees (DESIGN.md §16): one
# k-ary tree node is ONE task folding k partials, so the reduction costs
# (n-1)/(k-1) dispatches over ceil(log_k n) levels instead of n-1 over
# ceil(log2 n) — the dispatch overhead is what erodes linreg's scaling
MERGE_ARITY = 8


# --------------------------------------------------------------------- tasks
def _np_fill_fragment(seed: int, n: int, p: int, beta_seed: int = 1234,
                      noise: float = 0.1):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    beta_rng = np.random.default_rng(beta_seed)
    beta = beta_rng.standard_normal(p + 1)
    y = beta[0] + X @ beta[1:] + noise * rng.standard_normal(n)
    return X.astype(np.float64), y.astype(np.float64)


def lr_fill_fragment(seed: int, n: int, p: int, beta_seed: int = 1234,
                     noise: float = 0.1, device=None):
    """Synthetic (X, y) with a hidden ground-truth beta (shared seed),
    float64 on ``device``."""
    dev = resolve_device(device)
    X, y = _np_fill_fragment(seed, n, p, beta_seed, noise)
    return torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)


def _with_intercept(X: torch.Tensor) -> torch.Tensor:
    ones = torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)
    return torch.cat([ones, X], dim=1)


def partial_ztz(frag) -> torch.Tensor:
    X, _ = frag
    Z = _with_intercept(X)
    return Z.T @ Z            # the paper's GEMM hot-spot (×4 GEMM tasks)


def partial_zty(frag) -> torch.Tensor:
    X, y = frag
    Z = _with_intercept(X)
    return Z.T @ y


def merge_add(a, b):
    return a + b


def compute_model_parameters(ztz: torch.Tensor, zty: torch.Tensor,
                             ridge: float = 0.0) -> torch.Tensor:
    A = ztz
    if ridge > 0.0:
        A = A + ridge * torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return torch.linalg.solve(A, zty)


def _np_genpred(seed: int, m: int, p: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, p))


def lr_genpred(seed: int, m: int, p: int, device=None) -> torch.Tensor:
    return torch.from_numpy(_np_genpred(seed, m, p)).to(resolve_device(device))


def compute_prediction(X_pred: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    return _with_intercept(X_pred) @ beta


# -------------------------------------------------------------------- driver
@dataclass
class LinRegResult:
    beta: np.ndarray
    predictions: np.ndarray
    n_tasks: int


def run_linreg(
    n_rows: int = 20_000,
    p: int = 100,
    n_pred: int = 4_000,
    fragments: int = 4,
    pred_blocks: int = 2,
    ridge: float = 0.0,
    merge_arity: int = MERGE_ARITY,
    seed: int = 0,
    device=None,
) -> LinRegResult:
    """Sequential-style RCOMPSs program (requires a started runtime).
    ``device=None`` runs on CUDA and raises where there is none."""
    dev = resolve_device(device)
    fill_t = api.task(lr_fill_fragment, name="LR_fill_fragment")
    ztz_t = api.task(partial_ztz, name="partial_ztz")
    zty_t = api.task(partial_zty, name="partial_zty")
    merge_t = api.task(merge_add, name="merge")
    fit_t = api.task(compute_model_parameters, name="compute_model_parameters")
    genpred_t = api.task(lr_genpred, name="LR_genpred")
    pred_t = api.task(compute_prediction, name="compute_prediction")

    frag_n = [n_rows // fragments] * fragments
    frag_n[-1] += n_rows - sum(frag_n)
    # fragment fan-outs use batched submission (DESIGN.md §14)
    frags = api.map_tasks(fill_t, [(seed + i, frag_n[i], p, 1234, 0.1, dev)
                                   for i in range(fragments)])

    ztzs = api.map_tasks(ztz_t, [(f,) for f in frags])
    ztys = api.map_tasks(zty_t, [(f,) for f in frags])
    # runtime collective: balanced k-ary merge trees (DESIGN.md §16)
    ztz = collectives.tree_reduce(ztzs, merge_t, arity=merge_arity)
    zty = collectives.tree_reduce(ztys, merge_t, arity=merge_arity)
    beta = fit_t(ztz, zty, ridge)

    blk_m = [n_pred // pred_blocks] * pred_blocks
    blk_m[-1] += n_pred - sum(blk_m)
    Xps = api.map_tasks(genpred_t, [(50_000 + seed + b, blk_m[b], p, dev)
                                    for b in range(pred_blocks)])
    preds = api.map_tasks(pred_t, [(Xp, beta) for Xp in Xps])
    beta_v = api.wait_on(beta)
    preds_v = api.wait_on(preds)
    n_merges = len(collectives.reduce_spec(fragments, arity=merge_arity))
    n_tasks = fragments * 3 + 2 * n_merges + 1 + 2 * pred_blocks
    return LinRegResult(beta_v.cpu().numpy(),
                        np.concatenate([q.cpu().numpy() for q in preds_v]), n_tasks)


# -------------------------------------------------------------------- oracle
def reference_linreg(n_rows, p, n_pred, fragments, pred_blocks, ridge=0.0, seed=0):
    """Single-shot float64 NumPy oracle of ``run_linreg``."""
    frag_n = [n_rows // fragments] * fragments
    frag_n[-1] += n_rows - sum(frag_n)
    frags = [_np_fill_fragment(seed + i, frag_n[i], p) for i in range(fragments)]
    X = np.concatenate([f[0] for f in frags])
    y = np.concatenate([f[1] for f in frags])
    Z = np.concatenate([np.ones((X.shape[0], 1)), X], axis=1)
    A = Z.T @ Z
    if ridge > 0.0:
        A = A + ridge * np.eye(A.shape[0])
    beta = np.linalg.solve(A, Z.T @ y)
    blk_m = [n_pred // pred_blocks] * pred_blocks
    blk_m[-1] += n_pred - sum(blk_m)
    preds = []
    for b in range(pred_blocks):
        Xp = _np_genpred(50_000 + seed + b, blk_m[b], p)
        preds.append(np.concatenate([np.ones((Xp.shape[0], 1)), Xp], axis=1) @ beta)
    return beta, np.concatenate(preds)


# --------------------------------------------------- simulator DAG generation
@dataclass
class LinRegCosts:
    fill: CostModel
    ztz: CostModel
    zty: CostModel
    merge: CostModel
    fit: CostModel
    genpred: CostModel
    predict: CostModel


def calibrate(p: int = 100, units=(1000, 4000, 8000), device=None) -> LinRegCosts:
    """Fit per-task cost models by timing the real task functions on
    ``device`` (CUDA unless ``device="cpu"``; each call timed between two
    synchronisations of the card)."""
    dev = resolve_device(device)

    def fill_u(u):
        return lambda: lr_fill_fragment(1, int(u), p, device=dev)

    def ztz_u(u):
        f = lr_fill_fragment(2, int(u), p, device=dev)
        return lambda: partial_ztz(f)

    def zty_u(u):
        f = lr_fill_fragment(3, int(u), p, device=dev)
        return lambda: partial_zty(f)

    def merge_u(u):
        a = torch.ones((p + 1, p + 1), dtype=torch.float64, device=dev)
        return lambda: merge_add(a, a)

    def fit_u(u):
        f = lr_fill_fragment(4, max(int(u), p + 8), p, device=dev)
        A, b = partial_ztz(f), partial_zty(f)
        return lambda: compute_model_parameters(A, b, 1e-6)

    def genpred_u(u):
        return lambda: lr_genpred(5, int(u), p, device=dev)

    def pred_u(u):
        f = lr_fill_fragment(6, max(int(u), p + 8), p, device=dev)
        A, b = partial_ztz(f), partial_zty(f)
        beta = compute_model_parameters(A, b, 1e-6)
        Xp = lr_genpred(7, int(u), p, device=dev)
        return lambda: compute_prediction(Xp, beta)

    return LinRegCosts(
        fill=calibrate_cost(fill_u, units, "LR_fill_fragment", device=dev),
        ztz=calibrate_cost(ztz_u, units, "partial_ztz", device=dev),
        zty=calibrate_cost(zty_u, units, "partial_zty", device=dev),
        merge=calibrate_cost(merge_u, (1,), "merge", device=dev),
        fit=calibrate_cost(fit_u, (1,), "compute_model_parameters", device=dev),
        genpred=calibrate_cost(genpred_u, units, "LR_genpred", device=dev),
        predict=calibrate_cost(pred_u, units, "compute_prediction", device=dev),
    )


def dag_spec(
    costs: LinRegCosts,
    n_rows: int,
    p: int,
    n_pred: int,
    fragments: int,
    pred_blocks: int,
    merge_arity: int = MERGE_ARITY,
) -> List[SimTask]:
    tasks: List[SimTask] = []
    tid = 0
    rows = n_rows // fragments
    fbytes = rows * (p + 1) * 8
    gbytes = (p + 1) * (p + 1) * 8
    fill_ids = []
    for _ in range(fragments):
        tasks.append(SimTask(tid, "LR_fill_fragment", costs.fill(rows), (),
                             out_bytes=fbytes))
        fill_ids.append(tid)
        tid += 1

    def emit_tree(leaf_parent_ids: List[int], leaf_name: str, leaf_cost: float,
                  leaf_bytes: int) -> int:
        nonlocal tid
        leaf_ids = []
        for pid in leaf_parent_ids:
            tasks.append(SimTask(tid, leaf_name, leaf_cost, (pid,), out_bytes=leaf_bytes))
            leaf_ids.append(tid)
            tid += 1
        # same k-ary collective shape the live runtime builds (§16): one
        # SimTask per tree node folding k children, cost (k-1) pair-merges
        merges = collectives.reduce_spec(len(leaf_ids), arity=merge_arity)
        merge_ids: List[int] = []
        for _, children in merges:
            deps = tuple(
                leaf_ids[c] if c < len(leaf_ids) else merge_ids[c - len(leaf_ids)]
                for c in children)
            name = "merge" if len(deps) == 2 else f"mergex{len(deps)}"
            tasks.append(SimTask(tid, name, costs.merge(1) * (len(deps) - 1),
                                 deps, out_bytes=leaf_bytes))
            merge_ids.append(tid)
            tid += 1
        return merge_ids[-1] if merge_ids else leaf_ids[-1]

    ztz_root = emit_tree(fill_ids, "partial_ztz", costs.ztz(rows), gbytes)
    zty_root = emit_tree(fill_ids, "partial_zty", costs.zty(rows), (p + 1) * 8)
    tasks.append(SimTask(tid, "compute_model_parameters", costs.fit(1),
                         (ztz_root, zty_root), out_bytes=(p + 1) * 8))
    fit_id = tid
    tid += 1
    mrows = n_pred // pred_blocks
    for _ in range(pred_blocks):
        tasks.append(SimTask(tid, "LR_genpred", costs.genpred(mrows), (),
                             out_bytes=mrows * p * 8))
        gen_id = tid
        tid += 1
        tasks.append(SimTask(tid, "compute_prediction", costs.predict(mrows),
                             (gen_id, fit_id), out_bytes=mrows * 8))
        tid += 1
    return tasks
