"""Fused RMSNorm over the last dimension: the port of
``repro/kernels/rmsnorm.py``.

Two versions of one function: ``y = x · (1/√(mean(x²) + eps)) · scale``
with fp32 math and the result in x's dtype; ``scale`` (d,) is cast to
fp32 before the multiply.

* :func:`rmsnorm_plain` — plain PyTorch, the arithmetic of the JAX layer
  the model uses (``repro/layers/norms.py``, ``1/sqrt``).  The Pallas
  kernel takes ``rsqrt`` instead, which may differ by an ulp; the tests
  hold the two within a stated tolerance.  The CPU tests use this
  version, and ``chip_smoke.py`` holds the kernel against it.
* :func:`rmsnorm_cuda` — the hand-written CUDA kernel
  (``csrc/rmsnorm.cu``, which documents its design and bound): short rows
  packed several to a warp, each lane's 16-byte packs kept in registers
  (:func:`layout`).  It takes contiguous bf16 or fp32 CUDA tensors and
  raises on anything else.

:func:`repro_torch.kernels.ops.rmsnorm` picks one by device.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

DTYPES = (torch.float32, torch.bfloat16)

launches = 0          # kernel launches since the last reset (plain int)
_count_lock = threading.Lock()


def _check_shapes(x, scale) -> None:
    if x.dim() < 1 or scale.dim() != 1 or x.shape[-1] != scale.shape[0]:
        raise ValueError(f"rmsnorm takes x (..., d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version; returns x's shape and dtype."""
    _check_shapes(x, scale)
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * (1.0 / torch.sqrt(var + eps))
    return (y * scale.to(torch.float32)).to(x.dtype)


MAX_PACKS_PER_LANE = 16   # kMaxPacksPerLane in csrc/rmsnorm.cu


def layout(d: int, itemsize: int, vec: bool = True) -> tuple:
    """(lanes per row, packs per lane, one pass) of the kernel for rows of
    ``d`` values of ``itemsize`` bytes, as ``csrc/rmsnorm.cu`` chooses:
    rows of up to 32 16-byte packs take the next power of two of lanes
    (one pack each); wider rows a warp, each lane a power of two of packs
    up to 16; past that, and off the packs (``vec`` false: elements
    instead of packs), a warp per row in two passes, lane l summing packs
    (or elements) l, l + 32, ... in order."""
    if vec:
        packs = d * itemsize // 16
        if packs <= 32:
            return 1 << max(0, packs - 1).bit_length(), 1, True
        per_lane = -(-packs // 32)
        if per_lane <= MAX_PACKS_PER_LANE:
            return 32, 1 << (per_lane - 1).bit_length(), True
        return 32, per_lane, False
    return 32, -(-d // 32), False


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Launch the CUDA kernel.  x (..., d) and scale (d,), each bf16 or
    fp32, contiguous, on one CUDA device.  Returns x's shape and dtype."""
    global launches
    _check_shapes(x, scale)
    dev = x.device
    for name, t in (("x", x), ("scale", scale)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"rmsnorm_cuda: {name} is on {t.device}, expected one CUDA device")
        if t.dtype not in DTYPES:
            raise TypeError(f"rmsnorm_cuda: {name} is {t.dtype}, expected float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"rmsnorm_cuda: {name} must be contiguous")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    # 16-byte packs where every row starts on a 16-byte boundary and the
    # scale's packs load whole
    vec = (d * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0 \
        and y.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rmsnorm_launch(
            x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d,
            int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16), int(vec),
            ctypes.c_float(eps), torch.cuda.get_device_properties(dev).multi_processor_count,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rmsnorm")
    with _count_lock:
        launches += 1
    return y
