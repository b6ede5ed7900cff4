"""Frozen copies of linear regression's data generators and partition
rules.

The benchmark's reference regenerates each ``run_linreg`` pipeline's data
from its seed with these copies, so that it takes nothing from the
program under test.  They are copied from
``src/repro_torch/algorithms/linreg.py`` (``_np_fill_fragment``,
``_np_genpred``, and the fragment and block splits and seed offsets of
``run_linreg``) at commit 292e7ba.  They stay frozen: a program that
changes its generators no longer computes what these produce, and the
benchmark says so by failing its check.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from bench.frozen.generators import split

# run_linreg: fragment i of a pipeline seeded s is generated from seed
# s + i, prediction block b from PRED_SEED_OFFSET + s + b, and every
# fragment's ground-truth beta from BETA_SEED
PRED_SEED_OFFSET = 50_000
BETA_SEED = 1234
NOISE = 0.1


def fragment(seed: int, n: int, p: int, beta_seed: int = BETA_SEED,
             noise: float = NOISE) -> Tuple[np.ndarray, np.ndarray]:
    """One (X, y) fragment: ``linreg._np_fill_fragment``."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    beta_rng = np.random.default_rng(beta_seed)
    beta = beta_rng.standard_normal(p + 1)
    y = beta[0] + X @ beta[1:] + noise * rng.standard_normal(n)
    return X.astype(np.float64), y.astype(np.float64)


def prediction_block(seed: int, m: int, p: int) -> np.ndarray:
    """One block of prediction inputs: ``linreg._np_genpred``."""
    return np.random.default_rng(seed).standard_normal((m, p))


def fragment_args(seed: int, n_rows: int, p: int, fragments: int) -> list:
    """``(seed, rows, p)`` of each fragment of one pipeline, in order."""
    return [(seed + i, n, p) for i, n in enumerate(split(n_rows, fragments))]


def prediction_args(seed: int, n_pred: int, p: int, blocks: int) -> list:
    """``(seed, rows, p)`` of each prediction block of one pipeline, in order."""
    return [(PRED_SEED_OFFSET + seed + b, m, p) for b, m in enumerate(split(n_pred, blocks))]
