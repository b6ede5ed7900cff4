"""Plain reference of one ``run_kmeans`` pipeline, its control, and the
comparison that decides ``correct`` for the ``kmeans`` kind.

The reference regenerates the pipeline's points and first centroids
from the seed (``bench/frozen/generators.py``) and computes Lloyd's
steps itself, in float64 (or, for the control, with TF32 products): from
a state (the centroids), assign every point to its nearest centroid, sum
and count per cluster, and take the means as the next state (an empty
cluster keeps its centroid); the step's sse is taken at the state it
starts from, as ``run_kmeans`` reports it.  It imports nothing of the
program.

Two runs of Lloyd's iterations from one start do not stay together: a
point within rounding of a tie between two centroids goes to either, the
next states differ by a few points' weight, and over tens of iterations
whole clusters can move an iteration earlier in one run than in the
other.  So the reference follows the program step by step: the first
step from its own start (worked out from the seed, which checks the
program's start), every later step from the state the program reached
(read from what ``run_kmeans`` receives each iteration).  Each
step is held by itself; together they cover the whole trajectory.

Numbers compared, each against the cell's limit:

* ``sse_gap``: the widest relative gap, over the steps, between the
  program's sse and the reference's from the same state: the kernel's
  distances and sse and the merge tree.
* ``step_gap``: the widest gap, over the steps, between the state the
  program reached and the reference's step from the same state, as a
  share of the points' weight: each cluster's centroid gap times its
  points, summed over the clusters, over the clusters' points times their
  RMS distance to the centroid (both from the reference's step).  A step
  that sends m of n points elsewhere reads about m/n whatever n is.  It
  holds the assignment, sums, counts and update.
* ``iterations_short``: iterations of the budget not run (exact, 0).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from bench.frozen import generators as gen
from bench.harness.numerics import dtype_of, no_tf32, operand

CHUNK = 1 << 20    # points per product


def _points(config: dict, seed: int, device, precision: str):
    X = gen.kmeans_points(seed, config["n_points"], config["d"], config["fragments"],
                          config["n_centers"], config["spread"])
    Xd = torch.from_numpy(X).to(device=device, dtype=dtype_of(precision))
    return Xd, operand(Xd, precision), (Xd * Xd).sum(1)


def step(X, x_op, x2, C: torch.Tensor, precision: str):
    """One Lloyd step from the float64 state ``C``: (sse at ``C``, the
    next state, each cluster's points' weight: count times RMS distance)."""
    k, d = C.shape
    dev = C.device
    c_op = operand(C, precision)
    c2 = (C.to(dtype_of(precision)) ** 2).sum(1)
    sums = torch.zeros((k, d), dtype=torch.float64, device=dev)
    counts = torch.zeros((k,), dtype=torch.int64, device=dev)
    sse_k = torch.zeros((k,), dtype=torch.float64, device=dev)
    for start in range(0, X.shape[0], CHUNK):
        xs = x_op[start:start + CHUNK]
        d2 = (x2[start:start + CHUNK, None] - 2.0 * (xs @ c_op.T)) + c2[None]
        assign = torch.argmin(d2, dim=1)
        sse_k += torch.bincount(assign, weights=d2.gather(1, assign[:, None])[:, 0].double(),
                                minlength=k)
        onehot = operand(torch.nn.functional.one_hot(assign, k), precision)
        sums += (onehot.T @ xs).double()
        counts += torch.bincount(assign, minlength=k)
    new = sums / counts.clamp(min=1)[:, None]
    weight = torch.sqrt(counts.double() * sse_k.clamp(min=0))
    return float(sse_k.sum()), torch.where((counts == 0)[:, None], C, new), weight


def reference(config: dict, traffic: dict, seed: int, states: Optional[List] = None,
              device="cpu", precision: str = "float64") -> dict:
    """{"sse_history", "states", "weights", "iterations"} of the pipeline
    seeded ``seed``: each step's sse, the state it reaches and its
    clusters' points' weight.  With ``states``
    (the states a program reached, in order) every step after the first
    starts from the program's state; without, from the reference's own."""
    no_tf32()
    if float(traffic.get("tol", 0.0)) != 0.0:
        raise ValueError("the kmeans reference runs the whole budget: the cell's tol must be 0")
    iters = int(traffic["max_iters"])
    X, x_op, x2 = _points(config, seed, device, precision)
    C = torch.from_numpy(gen.kmeans_initial_centroids(seed, config["k"], config["d"])).to(device)
    sses, reached, weights = [], [], []
    steps = iters if states is None else min(iters, len(states))
    for i in range(steps):
        if states is not None and i > 0:
            C = torch.as_tensor(np.asarray(states[i - 1], dtype=np.float64), device=device)
        sse, C, weight = step(X, x_op, x2, C, precision)
        sses.append(sse)
        reached.append(C.cpu().numpy())
        weights.append(weight.cpu().numpy())
    return {"sse_history": sses, "states": reached, "weights": weights, "iterations": iters}


def control(config: dict, traffic: dict, seed: int, device) -> dict:
    """The reference with TF32 products, in the program's place: its own
    trajectory."""
    return reference(config, traffic, seed, device=device, precision="tf32")


def compare(program: dict, ref: dict, limits: dict) -> dict:
    """The numbers compared: {"sse_gap", "step_gap", "iterations_short"}."""
    short = int(ref["iterations"]) - int(program["iterations"])
    ps = np.asarray(program["sse_history"], dtype=np.float64)
    rs = np.asarray(ref["sse_history"], dtype=np.float64)
    n = min(len(ps), len(rs))
    sse_gap = float(np.max(np.abs(ps[:n] - rs[:n]) / np.abs(rs[:n]))) if n else float("inf")
    pst, rst = program["states"], ref["states"]
    if len(pst) != len(rst) or not rst:
        step_gap = float("inf")
    else:
        step_gap = max(
            float(np.sum(w * np.linalg.norm(np.asarray(a, dtype=np.float64) - b, axis=1))
                  / np.sum(w))
            for a, b, w in zip(pst, rst, ref["weights"]))
    gaps = [g if np.isfinite(g) else float("inf") for g in (sse_gap, step_gap)]
    return {"sse_gap": gaps[0], "step_gap": gaps[1], "iterations_short": short}
