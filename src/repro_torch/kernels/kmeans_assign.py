"""Fused K-means assignment + partial sums (the paper's ``partial_sum``
task): the port of ``repro/kernels/kmeans_assign.py``.

Two versions of one function, with the Pallas kernel's semantics, in
fp32: each point goes to ``argmax_c (x·c − ½|c|²)`` (the first index on
ties); the outputs are the per-cluster sums ``(k, d)``, the counts
``(k,)`` int32 and ``sse = Σ (|x|² − 2·best)`` as a 0-d tensor.

* :func:`kmeans_assign_plain` — plain PyTorch (the one-hot contraction
  of the Pallas kernel).  The CPU tests use it, and ``chip_smoke.py``
  holds the kernel against it.
* :func:`kmeans_assign_cuda` — the hand-written CUDA kernel
  (``csrc/kmeans_assign.cu``, which documents its design and bound).  It
  is deterministic (no float atomics) and takes only contiguous fp32
  CUDA tensors.

:func:`repro_torch.kernels.ops.kmeans_assign` picks one by device.
"""
from __future__ import annotations

import math
import threading

import torch

from . import _build

_THREADS = 128        # points per tile (kThreads in csrc/kmeans_assign.cu)
_BLOCKS_PER_SM = 4    # persistent blocks per SM
_SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block may use

launches = 0          # kernel launches since the last reset (plain int)
_count_lock = threading.Lock()


def _check_shapes(x, centroids) -> None:
    if x.dim() != 2 or centroids.dim() != 2 or x.shape[1] != centroids.shape[1]:
        raise ValueError(f"kmeans_assign takes x (n, d) and centroids (k, d), got "
                         f"{tuple(x.shape)} and {tuple(centroids.shape)}")
    if x.shape[0] < 1 or centroids.shape[0] < 1:
        raise ValueError("kmeans_assign needs at least one point and one centroid")


def kmeans_assign_plain(x: torch.Tensor, centroids: torch.Tensor):
    """Plain PyTorch version.  Returns (sums (k, d) fp32, counts (k,)
    int32, sse 0-d fp32)."""
    _check_shapes(x, centroids)
    xf = x.to(torch.float32)
    c = centroids.to(torch.float32)
    half = xf @ c.T - 0.5 * (c * c).sum(1)[None, :]
    best = half.amax(dim=1)
    assign = torch.argmax(half, dim=1)     # the first index on ties
    onehot = torch.nn.functional.one_hot(assign, c.shape[0]).to(torch.float32)
    sums = onehot.T @ xf
    counts = onehot.sum(0).to(torch.int32)
    sse = ((xf * xf).sum(1) - 2.0 * best).sum()
    return sums, counts, sse


def smem_bytes(k: int, d: int) -> int:
    """Dynamic shared memory of one kernel block (see the .cu source)."""
    ld = _build.padded_ld(d)
    return ((k + _THREADS) * ld + k + k * d + _THREADS) * 4 + (_THREADS + k) * 4


def kmeans_assign_cuda(x: torch.Tensor, centroids: torch.Tensor):
    """Launch the CUDA kernel.  x (n, d) and centroids (k, d) fp32,
    contiguous, on one CUDA device.  Returns (sums (k, d) fp32, counts
    (k,) int32, sse 0-d fp32)."""
    global launches
    _check_shapes(x, centroids)
    dev = x.device
    for name, t in (("x", x), ("centroids", centroids)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kmeans_assign_cuda: {name} is on {t.device}, "
                             f"expected one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"kmeans_assign_cuda: {name} is {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"kmeans_assign_cuda: {name} must be contiguous")
    (n, d), k = x.shape, centroids.shape[0]
    if smem_bytes(k, d) > _SMEM_LIMIT:
        raise ValueError(f"kmeans_assign_cuda: k={k}, d={d} needs "
                         f"{smem_bytes(k, d)} B of shared memory per block, "
                         f"more than {_SMEM_LIMIT}")
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.int32, device=dev)
    sse = torch.empty((), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = min(math.ceil(n / _THREADS), _BLOCKS_PER_SM * sms)
    part_sums = torch.empty((blocks, k, d), dtype=torch.float32, device=dev)
    part_counts = torch.empty((blocks, k), dtype=torch.int32, device=dev)
    part_sse = torch.empty((blocks,), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.kmeans_assign_launch(
            x.data_ptr(), centroids.data_ptr(), n, k, d, blocks,
            part_sums.data_ptr(), part_counts.data_ptr(), part_sse.data_ptr(),
            sums.data_ptr(), counts.data_ptr(), sse.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "kmeans_assign")
    with _count_lock:
        launches += 1
    return sums, counts, sse
