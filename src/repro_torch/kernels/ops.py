"""Dispatch for the port's kernels, and their launch counters.

Each op takes the device of its tensors as the only switch: tensors on
the CPU go to the kernel's plain PyTorch version (that is how the CPU
tests run), tensors on a CUDA device go to the hand-written kernel —
which launches or raises; there is no fallback.  Mixed devices raise.

The launch counters are plain ints, one per kernel, kept by each
kernel's CUDA wrapper where it launches (``knn_topk.launches``, ...);
plain-version calls never count.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import flash_attention as _flash
from . import kmeans_assign as _kmeans
from . import knn_topk as _knn
from . import rglru_scan as _rglru
from . import rmsnorm as _rms
from . import ssd_scan as _ssd

KERNELS = {"knn_topk": _knn, "kmeans_assign": _kmeans, "rmsnorm": _rms,
           "flash_attention": _flash, "rglru_scan": _rglru, "ssd_scan": _ssd}


def _device_type(*tensors: torch.Tensor) -> str:
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
        raise ValueError(f"tensors on devices {sorted(str(t.device) for t in tensors)}: "
                         f"expected all on the CPU or all on one CUDA device")
    return kinds.pop()


def knn_topk(test_x, train_x, train_y, *, k: int = 5):
    """(dists (m, k), labels (m, k) int32) of the k nearest training rows."""
    if _device_type(test_x, train_x, train_y) == "cpu":
        return _knn.knn_topk_plain(test_x, train_x, train_y, k)
    return _knn.knn_topk_cuda(test_x, train_x, train_y, k)


def kmeans_assign(x, centroids):
    """(sums (k, d), counts (k,) int32, sse 0-d) of one fragment."""
    if _device_type(x, centroids) == "cpu":
        return _kmeans.kmeans_assign_plain(x, centroids)
    return _kmeans.kmeans_assign_cuda(x, centroids)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """``x · (1/√(mean(x²) + eps)) · scale`` over the last dim, in x's dtype."""
    if _device_type(x, scale) == "cpu":
        return _rms.rmsnorm_plain(x, scale, eps)
    return _rms.rmsnorm_cuda(x, scale, eps)


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """q (B, H, Sq, d), k/v (B, K, Skv, d) -> (B, H, Sq, d); masks count
    positions from 0 in q and k."""
    if _device_type(q, k, v) == "cpu":
        return _flash.flash_attention_plain(q, k, v, causal=causal, window=window)
    return _flash.flash_attention_cuda(q, k, v, causal=causal, window=window)


def rglru_scan(log_a, b, h0=None):
    """(y (B, S, R) in b's dtype, h_T (B, R) fp32) of
    ``h_t = exp(log_a_t)·h_{t−1} + b_t`` from ``h0`` (zeros if None)."""
    tensors = (log_a, b) if h0 is None else (log_a, b, h0)
    if _device_type(*tensors) == "cpu":
        return _rglru.rglru_scan_plain(log_a, b, h0)
    return _rglru.rglru_scan_cuda(log_a, b, h0)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """(y (B, S, H, P) fp32, final state (B, H, P, N) fp32) of the Mamba-2
    SSD scan from a zero state; ``chunk`` is the plain version's chunk
    length (the function does not depend on it)."""
    if _device_type(x, dt, A, Bm, Cm) == "cpu":
        return _ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    return _ssd.ssd_scan_cuda(x, dt, A, Bm, Cm)


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        with mod._count_lock:
            mod.launches = 0
