"""The work of one ``kmeans_assign`` call, as the algorithm needs it.

``kmeans_assign(x (n, d), centroids (k, d))`` assigns every point to its
nearest centroid and returns the per-cluster sums (k, d) fp32, counts
(k,) int32 and the sse.  Its least work is the score product,
``2·n·k·d`` operations, with every input byte read once (points and
centroids fp32) and every output byte written once.  The sums are
additions selected by the assignment, at most ``n·d`` of them, far below
the product; they are not counted.

This counts the algorithm's work and not an implementation's.  The
port's kernel runs the scores as 3xTF32 and the sums through one-hot
tensor-core products; counting those would make the yardstick move
whenever a PR changed the scheme.  At the benchmark's shapes the call is
bound by its bytes.  Copied to the benchmark at commit 6a9b660 and
frozen.
"""
from __future__ import annotations

KERNELS = ("kmeans_tc_partials", "kmeans_reduce_blocks", "half_sqnorms",
           "kmeans_wide_partials")   # the device kernels one call may launch
PEAK = "tf32"


def work(n: int, d: int, k: int) -> tuple:
    """(operations, bytes) of one call."""
    flops = 2.0 * n * k * d
    nbytes = 4.0 * (n * d + k * d) + 4.0 * (k * d + k + 1)
    return flops, nbytes
