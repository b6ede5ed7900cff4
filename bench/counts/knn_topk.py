"""The work of one ``knn_topk`` call, as the algorithm needs it.

``knn_topk(test (m, d), train (n, d), labels (n,), k)`` returns the k
smallest squared distances of each test row, with their labels.  Its
least work is one distance product, ``2·m·n·d`` operations, with every
input byte read once (test and training rows fp32, labels int32) and
every output byte written once (k distances fp32 and k labels int32 a
row).

This counts the algorithm's work and not an implementation's.  The
port's kernel runs the product as 3xTF32 (three TF32 products a pair, to
keep fp32 accuracy on the tensor cores) and reads the training rows
again in tiles; counting those would make the yardstick move whenever a
PR changed the scheme.  Against the dense TF32 peak a single-pass
product at full rate reads 100%, and the 3xTF32 scheme at most a third.
Copied to the benchmark at commit 6a9b660 and frozen.
"""
from __future__ import annotations

KERNELS = ("row_sqnorms", "knn_chunk_topk", "knn_merge_chunks", "knn_wide_topk",
           "knn_wide_merge")   # the device kernels one call may launch
PEAK = "tf32"                  # the product's peak in bench/harness/peaks.py


def work(m: int, n: int, d: int, k: int) -> tuple:
    """(operations, bytes) of one call."""
    flops = 2.0 * m * n * d
    nbytes = 4.0 * (m * d + n * d + n) + 8.0 * m * k
    return flops, nbytes
