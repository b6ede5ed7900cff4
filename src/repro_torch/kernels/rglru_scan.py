"""The RG-LRU linear recurrence ``h_t = exp(log_a_t)·h_{t−1} + b_t``: the
port of ``repro/kernels/rglru_scan.py``.

Two versions of one function, with the Pallas kernel's semantics:
``log_a``, ``b`` ``(B, S, R)``, each bf16 or fp32; ``h0`` ``(B, R)`` or
``None`` (zeros).  The state is fp32, elementwise over the R channels.
Returns ``y`` ``(B, S, R)`` in b's dtype (every step's state, rounded)
and ``h_T`` ``(B, R)`` in fp32.  Any R: nothing is padded to a block.

* :func:`rglru_scan_plain` — plain PyTorch: a loop over time in fp32, as
  ``repro/kernels/ref.py``'s ``rglru_scan_ref``.  The CPU tests use it,
  and ``chip_smoke.py`` holds the kernel against it.
* :func:`rglru_scan_cuda` — the hand-written CUDA kernel
  (``csrc/rglru_scan.cu``, which documents its design and bound): one
  thread per (batch, channel) walks time with h in a register.  It takes
  contiguous CUDA tensors and raises on anything else.

:func:`repro_torch.kernels.ops.rglru_scan` picks one by device.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)

launches = 0          # kernel launches since the last reset (plain int)
_count_lock = threading.Lock()


def _check_shapes(log_a, b, h0) -> None:
    if b.dim() != 3 or log_a.shape != b.shape:
        raise ValueError(f"rglru_scan takes log_a and b (B, S, R) of one shape, got "
                         f"{tuple(log_a.shape)} and {tuple(b.shape)}")
    if h0 is not None and tuple(h0.shape) != (b.shape[0], b.shape[2]):
        raise ValueError(f"rglru_scan: h0 {tuple(h0.shape)} does not fit b {tuple(b.shape)}")


def rglru_scan_plain(log_a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (y (B, S, R) in b's dtype, h_T (B, R) fp32).
    On the meta device, which holds shapes only, the loop over time would
    compute nothing but them: the outputs' shapes come directly, still
    joined to the inputs for autograd (a dry run's backward reaches the
    gates through them)."""
    _check_shapes(log_a, b, h0)
    Bsz, S, R = b.shape
    if b.device.type == "meta":
        y = log_a.to(torch.float32) + b.to(torch.float32)
        h = y[:, -1] if h0 is None else y[:, -1] + h0.to(torch.float32)
        return y.to(b.dtype), h
    h = (torch.zeros((Bsz, R), dtype=torch.float32, device=b.device) if h0 is None
         else h0.to(torch.float32))
    a = torch.exp(log_a.to(torch.float32))
    bf = b.to(torch.float32)
    ys = []
    for t in range(S):
        h = a[:, t] * h + bf[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1).to(b.dtype), h


def rglru_scan_cuda(log_a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel.  log_a and b (B, S, R), each bf16 or fp32,
    contiguous, on one CUDA device; h0 (B, R) on it or None (it is read
    in fp32).  Returns (y in b's dtype, h_T fp32)."""
    global launches
    _check_shapes(log_a, b, h0)
    dev = b.device
    named = [("log_a", log_a), ("b", b)] + ([("h0", h0)] if h0 is not None else [])
    for name, t in named:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"rglru_scan_cuda: {name} is on {t.device}, expected one CUDA device")
        if t.dtype not in DTYPES:
            raise TypeError(f"rglru_scan_cuda: {name} is {t.dtype}, expected float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"rglru_scan_cuda: {name} must be contiguous")
    Bsz, S, R = b.shape
    h0f = h0.to(torch.float32) if h0 is not None else None
    y = torch.empty_like(b)
    h_last = torch.empty((Bsz, R), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rglru_scan_launch(
            log_a.data_ptr(), b.data_ptr(), h0f.data_ptr() if h0f is not None else None,
            y.data_ptr(), h_last.data_ptr(), Bsz, S, R, int(log_a.dtype == torch.bfloat16),
            int(b.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rglru_scan")
    with _count_lock:
        launches += 1
    return y, h_last
