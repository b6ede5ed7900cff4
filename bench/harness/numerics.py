"""Precisions of the plain references and their controls.

The configurations state fp32 on the card (products at fp32 accuracy).
The reference computes in float64.  Its control computes in the nearest
precision below the stated one, TF32: every operand of a product is
rounded to TF32's 10-bit mantissa (to nearest, ties to even) and the
product of two rounded operands is summed in fp32, which is what a
single-pass TF32 tensor-core product does.  The rounding is done by hand
so that the control reads the same on the CPU and on the card, whatever
``allow_tf32`` says.
"""
from __future__ import annotations

import torch

PRECISIONS = ("float64", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: expected one of {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 ``t`` rounded to TF32 (10 mantissa bits, to nearest even)."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32).view(t.shape)


def operand(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` as an operand of a product in ``precision``."""
    t = t.to(dtype_of(precision))
    return round_tf32(t) if precision == "tf32" else t


def no_tf32():
    """Full fp32 products in torch's own matmuls, on the card too: the
    reference's and the control's products are exactly as written."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
