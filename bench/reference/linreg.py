"""Plain reference of one ``run_linreg`` pipeline, its control, and the
comparison that decides ``correct`` for the ``linreg`` kind.

The reference regenerates the pipeline's fragments and prediction blocks
from the seed (``bench/frozen/linreg.py``), forms Z = [1 X] block by
block (one fragment at a time, so that it fits), sums Z'Z and Z'y over
the blocks, solves the normal equations and predicts [1 X_p] beta, all
in float64 with torch's own operations (TF32 off).  Its control is the
same computation in float32, the precision just below the
configuration's: it casts the generated data itself.  It imports nothing
of the program.

Numbers compared, each against the cell's limit:

* ``beta_gap``: max |beta - beta_ref| / max |beta_ref|: the Gram and
  Z'y partials, both merge trees and the solve.
* ``pred_gap``: max |prediction - prediction_ref| / RMS(prediction_ref),
  over every prediction row: the prediction blocks and bodies, and beta
  through them.

A missing row, a wrong shape or a value that is not finite reads
``inf``.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.frozen import linreg as frozen
from bench.frozen.generators import in_threads
from bench.harness.numerics import no_tf32

DTYPES = {"float64": torch.float64, "float32": torch.float32}
THREADS = 4     # blocks generated at once on the host


def _blocks(fn, args):
    """``fn(*a)`` for each of ``args``, in order, ``THREADS`` at a time."""
    for i in range(0, len(args), THREADS):
        yield from in_threads(fn, args[i:i + THREADS], threads=THREADS)


def _with_ones(X: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device), X], dim=1)


def reference(config: dict, traffic: dict, seed: int, device="cpu",
              precision: str = "float64") -> dict:
    """{"beta" (p+1,), "predictions" (n_pred,)} of the pipeline seeded
    ``seed``, computed in ``precision``."""
    no_tf32()
    dt = DTYPES[precision]
    p = int(config["p"])
    ztz = torch.zeros((p + 1, p + 1), dtype=dt, device=device)
    zty = torch.zeros((p + 1,), dtype=dt, device=device)
    frags = frozen.fragment_args(seed, int(config["n_rows"]), p, int(config["fragments"]))
    for X, y in _blocks(lambda s, n, q: frozen.fragment(s, n, q, int(config["beta_seed"]),
                                                         float(config["noise"])), frags):
        Z = _with_ones(torch.from_numpy(X).to(device=device, dtype=dt))
        ztz += Z.T @ Z
        zty += Z.T @ torch.from_numpy(y).to(device=device, dtype=dt)
        del Z
    beta = torch.linalg.solve(ztz, zty)
    blocks = frozen.prediction_args(seed, int(traffic["n_pred"]), p, int(traffic["pred_blocks"]))
    preds = [_with_ones(torch.from_numpy(Xp).to(device=device, dtype=dt)) @ beta
             for Xp in _blocks(frozen.prediction_block, blocks)]
    return {"beta": beta.double().cpu().numpy(),
            "predictions": torch.cat(preds).double().cpu().numpy()}


def control(config: dict, traffic: dict, seed: int, device) -> dict:
    """The reference in float32, in the program's place."""
    return reference(config, traffic, seed, device=device, precision="float32")


def _gap(got, want, scale: float) -> float:
    got = np.asarray(got, dtype=np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.max(np.abs(got - want)) / scale)


def compare(program: dict, ref: dict, limits: dict) -> dict:
    """The numbers compared: {"beta_gap", "pred_gap"}."""
    beta, preds = ref["beta"], ref["predictions"]
    return {"beta_gap": _gap(program["beta"], beta, float(np.max(np.abs(beta)))),
            "pred_gap": _gap(program["predictions"], preds, float(np.sqrt(np.mean(preds ** 2))))}
