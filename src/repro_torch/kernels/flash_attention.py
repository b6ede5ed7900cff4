"""GQA attention forward (causal or not, optional sliding window): the
port of ``repro/kernels/flash_attention.py``.

Two versions of one function, with the Pallas kernel's semantics: q
``(B, H, Sq, d)``, k/v ``(B, K, Skv, d)``, H = K·G, query head h reads KV
head ``h // G``; scores ``(q · 1/√d) · k`` in fp32; key j is visible to
query i when ``j < Skv``, ``j <= i`` if causal and ``i - j < window`` if a
window is given.  Positions count from 0 in both q and k, also when
``Sq != Skv`` (FlashAttention-2's bottom-right alignment is *not* used).
Masked scores are ``NEG_INF = -1e30`` (finite, as in the Pallas kernel).
The output is in q's dtype.  A query row with no visible key has no
defined output (the Pallas kernel and ``ref.py`` disagree there too).

* :func:`flash_attention_plain` — plain PyTorch: the masked softmax
  written out densely (``ref.py``'s function, with the Pallas kernel's
  order of scaling).  The CPU tests use it, and ``chip_smoke.py`` holds
  the kernel against it.
* :func:`flash_attention_cuda` — the hand-written CUDA kernel
  (``csrc/flash_attention.cu``, which documents its design and bound):
  online softmax over streamed K/V blocks, fp32 accumulators.  bf16
  tensors go to its tensor-core route (``mma.sync`` with bf16 operands; P
  split into two bf16 terms so that P·V keeps fp32-grade weights), fp32
  tensors to its CUDA-core route (fp32 products).  It takes CUDA tensors
  whose last axis is contiguous — any strides otherwise, so the attention
  layer passes ``(B, S, H, d)`` tensors as transposed views without a
  copy; on the bf16 route every pointer and stride must be a multiple of
  16 bytes (its ``cp.async`` copies) — and returns its output in q's
  memory layout.

:func:`repro_torch.kernels.ops.flash_attention` picks one by device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)   # the configs' head dims and their reduced ones
DTYPES = (torch.float32, torch.bfloat16)

_ALIGN = 16           # bytes: the bf16 route's cp.async copies


def smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one kernel block (``TcCfg`` and
    ``smem_floats`` in the .cu source): on the bf16 route a 64-row q tile
    and a ring of two k and v tiles (64 rows, 32 at d 256), rows of d + 8
    bf16; on the fp32 route the q, k, v and P tiles."""
    if dtype == torch.bfloat16:
        block_k = 32 if d >= 256 else 64
        return (64 + 2 * 2 * block_k) * (d + 8) * 2
    return 4 * (64 * (d + 4) + 64 * (d + 1) + 64 * d + 64 * 68)


def _check_shapes(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, H, Sq, d), k and v (B, K, Skv, d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or k.shape[1] < 1 or H % k.shape[1]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (need the same B and d, and H % K == 0)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be None or >= 1, got {window}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version; returns (B, H, Sq, d) in q's dtype."""
    _check_shapes(q, k, v, window)
    B, H, Sq, d = q.shape
    K, Skv = k.shape[1], k.shape[2]
    qf = q.to(torch.float32).reshape(B, K, H // K, Sq, d) * (1.0 / math.sqrt(d))
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.to(torch.float32))
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window is not None:
        mask &= (q_pos - kv_pos) < window
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    return o.reshape(B, H, Sq, d).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Launch the CUDA kernel.  q (B, H, Sq, d), k and v (B, K, Skv, d),
    all bf16 or all fp32 with a contiguous last axis, on one CUDA device;
    d in ``HEAD_DIMS``; bf16 tensors with addresses and strides in
    multiples of 16 bytes.  Returns (B, H, Sq, d) in q's dtype and
    layout."""
    _check_shapes(q, k, v, window)
    dev = _build.require("flash_attention_cuda", [("q", q, None), ("k", k, None), ("v", v, None)],
                         contiguous=False)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention_cuda: {name} is {t.dtype}; q, k and v must "
                            f"all be float32 or all bfloat16")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention_cuda: {name} needs a contiguous last axis")
    B, H, Sq, d = q.shape
    K, Skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {d} not in {HEAD_DIMS}")
    o = torch.empty_like(q)   # q's strides where q is dense, else contiguous
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
            if t.data_ptr() % _ALIGN or any(t.stride(i) * 2 % _ALIGN for i in range(3)
                                            if t.shape[i] > 1):
                raise ValueError(f"flash_attention_cuda: bf16 {name} needs its address and "
                                 f"strides {t.stride()} in multiples of {_ALIGN} bytes")
    strides = (ctypes.c_longlong * 12)(*(t.stride(i) for t in (q, k, v, o) for i in range(3)))
    _build.launch("flash_attention", "flash_attention_launch", dev,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, K, Sq, Skv, d,
                  strides, int(causal), 0 if window is None else int(window),
                  int(q.dtype == torch.bfloat16))
    return o
