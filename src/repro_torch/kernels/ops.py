"""Dispatch for the port's kernels, and their launch counters.

Each op takes the device of its tensors as the only switch: tensors on
the CPU go to the kernel's plain PyTorch version (that is how the CPU
tests run), tensors on a CUDA device go to the hand-written kernel —
which launches or raises; there is no fallback.  Mixed devices raise.

The launch counters are plain ints, one per kernel, kept by each
kernel's CUDA wrapper where it launches (``knn_topk.launches``, ...);
plain-version calls never count.

Gradients.  The four model kernels (``rmsnorm``, ``flash_attention``,
``ssd_scan``, ``rglru_scan``) fill ``torch.empty`` outputs through
ctypes, which autograd cannot see; on the card each runs inside
:class:`KernelFunction`, whose forward is the kernel and whose backward
recomputes the plain version on the saved inputs and differentiates it.
That mirrors the reference: ``repro/kernels/ops.py``'s
``flash_attention_op`` is a ``custom_vjp`` whose backward recomputes
through ``ref.flash_attention_ref``, and the jnp layers differentiate
their norms and scans by autodiff.  No TPU kernel has a backward kernel,
so none is written here.  On the CPU the ops call the plain version
directly and autograd runs through it.  ``knn_topk`` and
``kmeans_assign`` have no gradient, as their Pallas calls have none
under ``jax.grad``: they refuse inputs that require grad.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

from . import _build
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


class KernelFunction(torch.autograd.Function):
    """``forward_fn(*inputs)`` in the forward; in the backward, the
    vector-Jacobian product of ``plain_fn`` recomputed under
    ``torch.enable_grad()`` on the saved inputs (the same tensors, views
    and strides included).  Outputs whose gradient is ``None`` (a scan's
    unused final state) are left out of it.  The ops on the card call
    ``KernelFunction.apply(cuda_wrapper, plain_version, *inputs)``; the CPU
    tests pass the plain version for both."""

    @staticmethod
    def forward(ctx, forward_fn: Callable, plain_fn: Callable, *inputs):
        ctx.plain_fn = plain_fn
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        return forward_fn(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            outs = ctx.plain_fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        used = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wrt = [t for t, need in zip(leaves, needs) if need]
        got = iter(torch.autograd.grad([o for o, _ in used], wrt, [g for _, g in used],
                                       allow_unused=True) if used and wrt else ())
        return (None, None, *(next(got, None) if need else None for need in needs))


def knn_topk(test_x, train_x, train_y, *, k: int = 5):
    """(dists (m, k), labels (m, k) int32) of the k nearest training rows;
    not differentiable."""
    _build.refuse_grad("knn_topk", test_x, train_x)
    if _device_type(test_x, train_x, train_y) == "cpu":
        return _knn.knn_topk_plain(test_x, train_x, train_y, k)
    return _knn.knn_topk_cuda(test_x, train_x, train_y, k)


def kmeans_assign(x, centroids):
    """(sums (k, d), counts (k,) int32, sse 0-d) of one fragment; not
    differentiable."""
    _build.refuse_grad("kmeans_assign", x, centroids)
    if _device_type(x, centroids) == "cpu":
        return _kmeans.kmeans_assign_plain(x, centroids)
    return _kmeans.kmeans_assign_cuda(x, centroids)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """``x · (1/√(mean(x²) + eps)) · scale`` over the last dim, in x's dtype."""
    if _device_type(x, scale) == "cpu":
        return _rms.rmsnorm_plain(x, scale, eps)
    return KernelFunction.apply(functools.partial(_rms.rmsnorm_cuda, eps=eps),
                                functools.partial(_rms.rmsnorm_plain, eps=eps), x, scale)


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """q (B, H, Sq, d), k/v (B, K, Skv, d) -> (B, H, Sq, d); masks count
    positions from 0 in q and k."""
    if _device_type(q, k, v) == "cpu":
        return _flash.flash_attention_plain(q, k, v, causal=causal, window=window)
    return KernelFunction.apply(
        functools.partial(_flash.flash_attention_cuda, causal=causal, window=window),
        functools.partial(_flash.flash_attention_plain, causal=causal, window=window), q, k, v)


def rglru_scan(log_a, b, h0=None):
    """(y (B, S, R) in b's dtype, h_T (B, R) fp32) of
    ``h_t = exp(log_a_t)·h_{t−1} + b_t`` from ``h0`` (zeros if None)."""
    tensors = (log_a, b) if h0 is None else (log_a, b, h0)
    if _device_type(*tensors) == "cpu":
        return _rglru.rglru_scan_plain(log_a, b, h0)
    return KernelFunction.apply(_rglru.rglru_scan_cuda, _rglru.rglru_scan_plain, log_a, b, h0)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """(y (B, S, H, P) fp32, final state (B, H, P, N) fp32) of the Mamba-2
    SSD scan from a zero state; ``chunk`` is the plain version's chunk
    length (the function does not depend on it)."""
    if _device_type(x, dt, A, Bm, Cm) == "cpu":
        return _ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
    return KernelFunction.apply(_ssd.ssd_scan_cuda,
                                functools.partial(_ssd.ssd_scan_plain, chunk=chunk),
                                x, dt, A, Bm, Cm)


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        with mod._count_lock:
            mod.launches = 0
